// Fused multi-head attention over the token-major (B, T, H, Dh) layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_mha` (fdtpu/kernels/attention.py, `_mha_kernel`).
// Contract, per batch element b and head h:
//
//     out[b, :, h, :] = softmax(q[b, :, h, :] k[b, :, h, :]^T / sqrt(Dh)) v[b, :, h, :]
//
// with q (B, Tq, H, Dh), k and v (B, Tk, H, Dh), out (B, Tq, H, Dh), all in one type (float32
// or bfloat16).  Scores are float32; the true row max (no padding) is subtracted before exp;
// the weights are divided by the row sum (>= 1 after the shift, so no clamp) and rounded to
// v's type before the value product, whose sum is float32.  Tq may differ from Tk: the
// token-level cache attends `token_budget` query rows to all T keys.
//
// Design (a first, simple kernel; speed is later work).  One block per (batch element, group
// of heads, tile of query rows), 8 warps.  In (B, T, H, Dh) one head's key row is Dh values
// at a stride of H*Dh, so a block stages the K and V columns of its group of heads with
// coalesced loads (each key row of the group is contiguous; a warp takes one row, its lanes
// the columns) into shared memory as float32, transposed to (group*Dh, Tk) with an odd
// leading dimension so that the lanes of a warp read consecutive keys without bank
// conflicts; the tile's q rows are staged too, pre-scaled by log2(e)/sqrt(Dh) so that exp2
// gives the exponentials.  Groups are sized so that a block holds about 56 KB (four blocks
// on an SM; the flagship's 187 keys take groups of 4 heads, T = 501 groups of 2), and the
// query tile shrinks from 32 rows to 8 while the grid would leave SMs idle (the token
// level's 24 rows).  A warp takes one (query row, head) at a time: its lanes stride over
// the keys for the row max, then for exp2, the row sum and the Dh-wide accumulation
// (bfloat16: a pass for the sum first, then the weights normalized and rounded to
// bfloat16 before the value product, as the contract rounds them); shuffles reduce across
// lanes and lanes d < Dh write the output.
//
// What bounds it on an H100: at the token level's shape (B=128, Tq=24, Tk=187, H=12, Dh=6)
// one call does 4*B*H*Tq*Tk*Dh = 165 MFLOP and moves 15.6 MB (K and V dominate): bytes bound
// it (4.6 us).  At the square shape of the KV level's cached modes (Tq = Tk = 187) it does
// 1.29 GFLOP of float32 multiply-add on 27.6 MB: operations bound it (20 us).  Dh = 6 fits no
// tensor-core tile, so this kernel uses the CUDA cores (PERF.md has its times).
//
// Built with nvcc into a shared library with a plain C interface (loaded with ctypes);
// the kernel runs on the caller's stream, does not synchronize and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 32;  // query rows of a tile; shrunk to kMinRows for small grids
constexpr int kMinRows = 8;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kTargetSmem = 56 * 1024;  // four blocks on an SM
constexpr int kMaxSmem = 232448;        // bytes of shared memory a Hopper block may use
constexpr float kLog2e = 1.4426950408889634f;

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

// Leading dimension of the staged (columns, Tk) slabs: odd, so consecutive columns fall in
// different banks when the block writes them.
__host__ __device__ __forceinline__ int slab_ld(int kv_len) { return kv_len | 1; }

// Shared memory of one head: its K and V slabs and its columns of a full query tile.
__host__ __device__ __forceinline__ size_t head_smem(int kv_len, int head_dim) {
  return sizeof(float) * (size_t)head_dim * (2 * (size_t)slab_ld(kv_len) + kMaxRows);
}

// One query row against the staged keys of one head, in log2 units.
template <int MAXDH>
__device__ __forceinline__ float score(const float (&qr)[MAXDH], const float* kh, int ld, int j,
                                       int head_dim) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < MAXDH; ++d)
    if (d < head_dim) s = fmaf(qr[d], kh[d * ld + j], s);
  return s;
}

// MAXDH bounds the per-lane register arrays; head_dim <= MAXDH is the runtime width.
template <typename T, int MAXDH>
__global__ void __launch_bounds__(kThreads)
    fused_mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int q_len, int kv_len, int n_head, int head_dim,
                     int group, int tile_rows, float q_scale) {
  extern __shared__ float smem[];
  const int ld = slab_ld(kv_len);
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * group;
  const int heads = min(group, n_head - h0);
  const int width = heads * head_dim;
  const int d_model = n_head * head_dim;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, q_len - row0);
  float* ks = smem;                                   // ks[c * ld + j] = k[b, j, h0*Dh + c]
  float* vs = smem + (size_t)group * head_dim * ld;  // vs[c * ld + j] = v[b, j, h0*Dh + c]
  float* qs = vs + (size_t)group * head_dim * ld;    // qs[r * width + c] = q[b, row0+r, h0*Dh + c]

  // Stage: a warp per key (query) row of the group, its lanes over the row's columns.
  const size_t kv_offset = (size_t)b * kv_len * d_model + (size_t)h0 * head_dim;
  for (int j = warp; j < kv_len; j += kWarps) {
    const size_t at = kv_offset + (size_t)j * d_model;
    for (int c = lane; c < width; c += 32) {
      ks[c * ld + j] = load_f32(k + at + c);
      vs[c * ld + j] = load_f32(v + at + c);
    }
  }
  for (int r = warp; r < rows; r += kWarps) {
    const size_t at = ((size_t)b * q_len + row0 + r) * d_model + (size_t)h0 * head_dim;
    for (int c = lane; c < width; c += 32) qs[r * width + c] = load_f32(q + at + c) * q_scale;
  }
  __syncthreads();

  for (int item = warp; item < rows * heads; item += kWarps) {
    const int r = item / heads;
    const int hh = item - r * heads;
    float qr[MAXDH];
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) qr[d] = d < head_dim ? qs[r * width + hh * head_dim + d] : 0.f;
    const float* kh = ks + (size_t)hh * head_dim * ld;
    const float* vh = vs + (size_t)hh * head_dim * ld;

    float m = -INFINITY;
    for (int j = lane; j < kv_len; j += 32) m = fmaxf(m, score(qr, kh, ld, j, head_dim));
    const float row_max = warp_max(m);

    float acc[MAXDH];
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) acc[d] = 0.f;
    float sum = 0.f;
    if constexpr (std::is_same<T, float>::value) {
      // float32: rounding the weights to v's type is the identity, so the division by the
      // row sum moves after the accumulation.
      for (int j = lane; j < kv_len; j += 32) {
        const float p = exp2f(score(qr, kh, ld, j, head_dim) - row_max);
        sum += p;
#pragma unroll
        for (int d = 0; d < MAXDH; ++d)
          if (d < head_dim) acc[d] = fmaf(p, vh[d * ld + j], acc[d]);
      }
      sum = warp_sum(sum);
    } else {
      for (int j = lane; j < kv_len; j += 32) sum += exp2f(score(qr, kh, ld, j, head_dim) - row_max);
      const float inv_sum = 1.f / warp_sum(sum);
      for (int j = lane; j < kv_len; j += 32) {
        const float w = __bfloat162float(
            __float2bfloat16(exp2f(score(qr, kh, ld, j, head_dim) - row_max) * inv_sum));
#pragma unroll
        for (int d = 0; d < MAXDH; ++d)
          if (d < head_dim) acc[d] = fmaf(w, vh[d * ld + j], acc[d]);
      }
      sum = 1.f;
    }
    const size_t o = ((size_t)b * q_len + row0 + r) * d_model + (size_t)(h0 + hh) * head_dim;
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) {
      if (d < head_dim) {
        const float a = warp_sum(acc[d]);
        if (lane == d) store_f32(out + o + d, a / sum);
      }
    }
  }
}

template <typename T, int MAXDH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int q_len,
                   int kv_len, int n_head, int head_dim, int device, cudaStream_t stream) {
  // Groups of heads that hold about kTargetSmem (at least one head, at most kMaxSmem), then
  // equal groups.
  const size_t per_head = head_smem(kv_len, head_dim);
  if (per_head > kMaxSmem) return cudaErrorInvalidValue;
  const int fit = max(1, min(n_head, (int)(kTargetSmem / per_head)));
  const int n_groups = (n_head + fit - 1) / fit;
  const int group = (n_head + n_groups - 1) / n_groups;
  const size_t smem = per_head * group;
  // The query tile shrinks while the grid would not put four blocks on every SM.
  int sms = 0;
  const cudaError_t attr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (attr != cudaSuccess) return attr;
  int rows = kMaxRows;
  while (rows > kMinRows &&
         (size_t)batch * n_groups * ((q_len + rows - 1) / rows) < 4 * (size_t)sms)
    rows /= 2;
  auto kernel = fused_mha_kernel<T, MAXDH>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((q_len + rows - 1) / rows, n_groups, batch);
  const float q_scale = kLog2e / sqrtf((float)head_dim);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), q_len,
                                           kv_len, n_head, head_dim, group, rows, q_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* out, int batch,
                              int q_len, int kv_len, int n_head, int head_dim, int device,
                              cudaStream_t stream) {
  if (head_dim <= 8)
    return launch<T, 8>(q, k, v, out, batch, q_len, kv_len, n_head, head_dim, device, stream);
  if (head_dim <= 16)
    return launch<T, 16>(q, k, v, out, batch, q_len, kv_len, n_head, head_dim, device, stream);
  if (head_dim <= 32)
    return launch<T, 32>(q, k, v, out, batch, q_len, kv_len, n_head, head_dim, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `device` is the CUDA ordinal the tensors live on.
// Returns the cudaError_t of the launch (0 = success).  The caller checks shapes,
// contiguity and shared-memory size beforehand.
extern "C" int fdtpu_fused_mha_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int batch, int q_len, int kv_len, int n_head,
                                   int head_dim, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(q, k, v, out, batch, q_len, kv_len, n_head, head_dim,
                                         device, s);
  if (dtype == 1)
    return (int)dispatch_head_dim<__nv_bfloat16>(q, k, v, out, batch, q_len, kv_len, n_head,
                                                 head_dim, device, s);
  return (int)cudaErrorInvalidValue;
}
