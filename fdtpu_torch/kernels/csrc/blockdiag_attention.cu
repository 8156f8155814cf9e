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
// What bounds it on an H100: at the flagship shape (B=128, T=187, H=12, Dh=6) one call
// does 4*B*H*T^2*Dh = 1.29 GFLOP of float32 multiply-add and B*H*T^2 = 53.7M exps, and
// moves 27.6 MB of q/k/v/out: operations, not bytes, bound it (20 us; PERF.md).  Dh = 6
// fits no tensor-core tile and plain TF32 misses the float32 tolerance, so the products
// run on the CUDA cores' FMA pipe and the exps on the MUFU pipe (1/8 of the FMA rate).
//
// Design: one pass over the keys, no shuffles.  A thread owns R query rows (Width<DH>:
// two at Dh = 6, one elsewhere) and keeps their q, pre-scaled by log2(e)/sqrt(Dh), the
// running max, sum and Dh accumulators in registers, so each key read from shared memory
// feeds R rows.  A block of up to 256 threads covers all the rows of one (batch, head)
// when T <= 256 * R (96 threads at T = 187), so K and V are staged once per (batch,
// head), as float32 records [k | v] (blockdiag_common.cuh) that every lane reads as the
// same broadcast 16-byte vectors.  The keys go through an online softmax in exp2 units in
// chunks of C (8 at Dh <= 8): the scores of a chunk, one max and one rescale of the sum
// and accumulators per chunk (no per-key branch), then exp2 and the accumulation.  The
// shifted exps go through ex2.approx.ftz (a weight under 2^-126 of the row's largest
// flushes to 0).  With `shift` off the max stays 0, nothing is rescaled and exp2f keeps
// denormals.  At a fixed count of exps the time grows with Dh (chip_smoke.py's head_dim
// sweep, PERF.md): the FMA pipe binds, not MUFU.  Where T exceeds a key tile (256 keys
// at Dh <= 8, 16 KB), K and V stream through shared memory tile by tile with a barrier
// between tiles; the flagship's 187 keys are one tile, so no cp.async double buffering
// was built for the long-T path.  Each thread loads its q rows and writes its outputs as
// 4-byte words (one 24-byte run a row at Dh = 6).
//
// Built with nvcc into a shared library with a plain C interface (loaded with ctypes);
// the kernel runs on the caller's stream, does not synchronize and allocates nothing.

#include "blockdiag_common.cuh"

namespace {

template <typename T, int DH>
__global__ void __launch_bounds__(kMaxThreads)
    blockdiag_mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out, int seq,
                             int n_head, int head_dim, float q_scale, int shift) {
  constexpr int R = Width<DH>::R, C = Width<DH>::C;
  constexpr int KT = tile<DH>();
  extern __shared__ float4 smem4[];
  float* keys = reinterpret_cast<float*>(smem4);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d_model = n_head * head_dim;
  const size_t kv_offset = ((size_t)b * n_head + h) * (size_t)head_dim * seq;
  const T* kbh = k + kv_offset;
  const T* vbh = v + kv_offset;
  const int row0 = blockIdx.x * blockDim.x * R + threadIdx.x;

  float qr[R][DH], acc[R][DH], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * blockDim.x;
    const T* qrow = q + ((size_t)b * seq + min(row, seq - 1)) * d_model + (size_t)h * head_dim;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qr[r][d] = d < head_dim ? load_f32(qrow + d) * q_scale : 0.f;
      acc[r][d] = 0.f;
    }
    m[r] = shift ? -INFINITY : 0.f;
    l[r] = 0.f;
  }

  for (int j0 = 0; j0 < seq; j0 += KT) {
    const int n = min(KT, seq - j0);
    if (j0 > 0) __syncthreads();  // every thread is done with the previous tile
    stage<T, DH>(keys, n, head_dim, kbh + j0, 1, (size_t)seq, 1.f, vbh + (size_t)j0 * head_dim,
                 (size_t)head_dim, 1);
    __syncthreads();
    if (shift)
      attend_tile<DH, R, C, true>(keys, n, qr, acc, m, l);
    else
      attend_tile<DH, R, C, false>(keys, n, qr, acc, m, l);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * blockDim.x;
    if (row >= seq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + ((size_t)b * seq + row) * d_model + (size_t)h * head_dim;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < head_dim) store_f32(orow + d, acc[r][d] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int seq,
                   int n_head, int head_dim, int shift, cudaStream_t stream) {
  constexpr int R = Width<DH>::R;
  const size_t smem = sizeof(float) * Width<DH>::E * (size_t)min(seq, tile<DH>());
  auto kernel = blockdiag_mha_fwd_kernel<T, DH>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // The fewest warps that give every thread R rows, up to kMaxThreads; then row tiles.
  const int per_thread = (seq + R - 1) / R;
  const int threads = min(kMaxThreads, (per_thread + 31) / 32 * 32);
  const int rows = threads * R;
  const dim3 grid((seq + rows - 1) / rows, n_head, batch);
  const float q_scale = kLog2e / sqrtf((float)head_dim);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), seq,
                                          n_head, head_dim, q_scale, shift);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* out, int batch,
                              int seq, int n_head, int head_dim, int shift, cudaStream_t stream) {
  if (head_dim <= 6) return launch<T, 6>(q, k, v, out, batch, seq, n_head, head_dim, shift, stream);
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
// contiguity and the sequence ceiling beforehand.
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
