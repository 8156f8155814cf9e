// Block-diagonal multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `blockdiag_mha` (fdtpu/kernels/blockdiag_attention.py,
// `_bd_kernel_batch` and the query-tiled `_bd_kernel`).  Contract, per head h:
//
//     out[b, t, h*Dh:(h+1)*Dh] = softmax(q_h k_h / sqrt(Dh)) v_h
//
// with q (B, T, D) merged heads, k (B, H, Dh, T) transposed keys, v (B, H, T, Dh),
// out (B, T, D) in the input type (float32 or bfloat16).  Scores, the row max, the
// exponentials and the sums are float32.  `shift` subtracts the row max before exp;
// without it the kernel computes exp(s) directly.  The denominator is clamped at 1e-30.
//
// The TPU kernel packs all heads into block-diagonal matrices padded to 128 key columns;
// its zero padded columns lift the row max to >= 0.  That is a packing artifact: this
// kernel takes the max over the real keys only.  The two agree whenever some real score
// in a row is > -88; where every score underflows, this kernel returns the true softmax
// average where the TPU kernel returns 0.
//
// Design (a first, simple kernel; speed is later work).  One block per
// (batch, head, tile of 64 query rows), 8 warps.  The block stages k_h and v_h of its
// (batch, head) in shared memory as float32, both laid out (Dh, T) so that the lanes of a
// warp read consecutive keys.  A warp takes one query row at a time: its lanes stride over
// the keys for the row max (shift), then for exp, the sum and the Dh-wide accumulation;
// warp shuffles reduce them and the lanes d < Dh write the output.
//
// What bounds it on an H100: at the flagship shape (B=128, T=187, H=12, Dh=6) one call
// does 4*B*H*T^2*Dh = 1.29 GFLOP of float32 multiply-add and B*H*T^2 = 53.7M exps, and
// moves 27.6 MB of q/k/v/out: operations, not bytes, bound it (PERF.md).  Dh = 6 fits no
// tensor-core tile, so this kernel uses the CUDA cores; wgmma/TMA are for a later redesign.
//
// Built with nvcc into a shared library with a plain C interface (loaded with ctypes);
// the kernel runs on the caller's stream, does not synchronize and allocates nothing.

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

// MAXDH bounds the per-lane register arrays; head_dim <= MAXDH is the runtime width.
template <typename T, int MAXDH>
__global__ void __launch_bounds__(kThreads)
    blockdiag_mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out, int seq,
                             int n_head, int head_dim, float scale, int shift) {
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

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerBlock;
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int row = row0 + r;
    if (row >= seq) break;  // uniform across the warp
    const T* qrow = q + ((size_t)b * seq + row) * d_model + (size_t)h * head_dim;
    float qr[MAXDH];
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) qr[d] = d < head_dim ? load_f32(qrow + d) : 0.f;

    float row_max = 0.f;
    if (shift) {
      float m = -INFINITY;
      for (int j = lane; j < seq; j += 32) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < MAXDH; ++d)
          if (d < head_dim) s = fmaf(qr[d], ks[d * seq + j], s);
        m = fmaxf(m, s * scale);
      }
      row_max = warp_max(m);
    }

    float denom = 0.f;
    float acc[MAXDH];
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) acc[d] = 0.f;
    for (int j = lane; j < seq; j += 32) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < MAXDH; ++d)
        if (d < head_dim) s = fmaf(qr[d], ks[d * seq + j], s);
      const float p = expf(s * scale - row_max);
      denom += p;
#pragma unroll
      for (int d = 0; d < MAXDH; ++d)
        if (d < head_dim) acc[d] = fmaf(p, vs[d * seq + j], acc[d]);
    }
    denom = fmaxf(warp_sum(denom), 1e-30f);
    T* orow = out + ((size_t)b * seq + row) * d_model + (size_t)h * head_dim;
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) {
      if (d < head_dim) {
        const float a = warp_sum(acc[d]);
        if (lane == d) store_f32(orow + d, a / denom);
      }
    }
  }
}

template <typename T, int MAXDH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int seq,
                   int n_head, int head_dim, int shift, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)head_dim * seq;
  auto kernel = blockdiag_mha_fwd_kernel<T, MAXDH>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((seq + kRowsPerBlock - 1) / kRowsPerBlock, n_head, batch);
  const float scale = 1.0f / sqrtf((float)head_dim);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), seq,
                                           n_head, head_dim, scale, shift);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* out, int batch,
                              int seq, int n_head, int head_dim, int shift, cudaStream_t stream) {
  if (head_dim <= 8) return launch<T, 8>(q, k, v, out, batch, seq, n_head, head_dim, shift, stream);
  if (head_dim <= 16)
    return launch<T, 16>(q, k, v, out, batch, seq, n_head, head_dim, shift, stream);
  if (head_dim <= 32)
    return launch<T, 32>(q, k, v, out, batch, seq, n_head, head_dim, shift, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `device` is the CUDA ordinal the tensors live on.
// Returns the cudaError_t of the launch (0 = success).  The caller checks shapes,
// contiguity and shared-memory size beforehand.
extern "C" int fdtpu_blockdiag_mha_fwd(const void* q, const void* k, const void* v, void* out,
                                       int dtype, int batch, int seq, int n_head, int head_dim,
                                       int shift, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(q, k, v, out, batch, seq, n_head, head_dim, shift, s);
  if (dtype == 1)
    return (int)dispatch_head_dim<__nv_bfloat16>(q, k, v, out, batch, seq, n_head, head_dim,
                                                 shift, s);
  return (int)cudaErrorInvalidValue;
}
