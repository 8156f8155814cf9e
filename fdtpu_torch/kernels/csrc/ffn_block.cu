// The FFN sublayer of the post-norm encoder layer, for Hopper (sm_90a): kernel F1.
//
//     out = LayerNorm(x + (relu(x W1^T + b1) W2^T + b2))        (gamma, beta, eps)
//
// with x (M, D) the rows after norm1 (M = B*T), W1 (F, D), b1 (F), W2 (D, F), b2, gamma and
// beta (D), out (M, D), all float32 and contiguous: the tail of `EncoderLayer._block`
// (fdtpu_torch/models/transformer.py) when no dropout acts.  The LayerNorm's statistics are
// float32 over the row's D values, its variance the biased one, as `layer_norm`
// (fdtpu_torch/kernels/ffn.py).
//
// Replaces no TPU kernel: the JAX package leaves the FFN to XLA (fdtpu/models/transformer.py).
// In the port it was two cuBLAS sgemms (TF32 off), a ReLU pass, the residual add and the
// LayerNorm's passes.  At the flagship (D 72, F 2048, M = 128 x 187 = 23,936) each layer wrote
// the (M, F) hidden to device memory (196 MB), read and wrote it again for the ReLU and read
// it once more in the second product, ~0.8 GB a layer that carries nothing, and the skinny
// K = 72 / N = 72 products ran at 21-33 TFLOP/s.
//
// What bounds it on an H100: operations.  4*M*D*F FLOP (14.1 GFLOP a layer at the flagship,
// 211 us at 67 TFLOP/s of fp32 FMA) against 13.8 MB of x and out (4 us at 3.35 TB/s); the
// layer's 1.18 MB of weights stay in L2.  Plain float32 FMA: no tensor cores, no TF32.  Inside
// an SM the shared-memory pipe binds next: it delivers 32 floats a clock against 128 FMA lanes,
// so a thread has to do 4 FMAs for every float it loads from shared memory.
//
// Design.  A block of 128 threads (4 warps, two blocks an SM) owns 128 rows and all D outputs,
// their sums in registers: a thread 8 rows x CPT columns (CPT 4 up to D 32, else 9; at D 72
// columns 4tx.., 32 + 4tx.. and 64 + tx).  It walks the hidden in chunks of 64 units:
//   H = relu(X W1c^T + b1c)   a thread 8 rows x 8 units: 64 FMAs a k for 16 floats loaded;
//   acc += H W2c^T            a thread 8 rows x 9 columns: 72 FMAs a unit for 17 floats.
// H goes through shared memory (transposed, a warp's 32 rows) and never reaches device memory;
// a warp reads only the H it wrote.  X's tile is staged transposed once and also gives the
// residual.  The weights go through shared memory in 4-byte cp.async copies that transpose
// them on the way, each buffer refilled while the other product runs: W1 of chunk c+1 during
// the second product of chunk c, W2 of chunk c+1 during the first product of chunk c+1 (two
// barriers a chunk).  The copies step by constants from a few base addresses a thread; with D
// a constant (72) every offset is an immediate.  The k loops unroll by 8: unrolled fully,
// ptxas hoists so many loads that registers spill.  Row strides of 4 mod 32 words (X^T, H^T,
// W1c^T) and the copies' lane maps keep the shared loads free of bank conflicts.  The epilogue
// adds b2 and x and takes the LayerNorm across the 8 lanes that hold a row (three shuffles a
// statistic).
//
// Few rows leave SMs idle (the token level's 128 x 24 = 3,072 rows are 24 blocks for 264
// resident), and 187 or 365 row tiles fill a last wave of 264 only in part, so the launcher
// splits the hidden across `splits` blocks a row tile, chosen from the shape and the card by
// fdtpu_ffn_block_splits.  Each split writes its partial sums to a scratch buffer, and a second
// kernel adds them in split order, then runs the epilogue (a warp a row).
//
// Deterministic: every sum is taken by one thread in one fixed order (no atomics), so two
// launches on the same inputs give the same bits.
//
// Built with nvcc into a shared library with a plain C interface (loaded with ctypes); the
// kernels run on the caller's stream, do not synchronize and allocate nothing.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;             // 4 warps: 32 rows a warp, 8 a thread
constexpr int kRows = 128;                // rows a block
constexpr int kChunk = 64;                // hidden units a chunk
constexpr int kRowStride = kRows + 4;     // X^T and H^T rows
constexpr int kChunkStride = kChunk + 4;  // W1c^T rows
constexpr int kMaxWidth = 72;
constexpr int kMaxSplits = 16;
constexpr int kMaxDevices = 64;           // devices whose kernel attributes are remembered as set
constexpr unsigned kFull = 0xffffffffu;

// A thread's CPT output columns: Q float4 groups, column 32q + 4tx + (0..3), then R = CPT % 4
// single columns 32Q + R tx + (0..R-1) (at D 72: 4tx.., 32 + 4tx.., 64 + tx).
template <int CPT>
struct Layout {
  static constexpr int kWidth = 8 * CPT;          // D, padded with zeros
  static constexpr int kQ = CPT / 4, kR = CPT % 4;
  static constexpr int kW2Stride = kWidth + 4;    // W2c^T rows
  static constexpr int kXs = kWidth * kRowStride;
  static constexpr int kW1 = kWidth * kChunkStride;
  static constexpr int kW2 = kChunk * kW2Stride;
  static constexpr int kHs = kChunk * kRowStride;
  static constexpr int kFloats = kXs + kW1 + kW2 + kHs;
  static_assert(kChunk * kWidth % kThreads == 0 && kRows * kWidth % kThreads == 0, "copy maps");
  static_assert(sizeof(float) * kFloats <= 232448, "shared memory of a block");

  __device__ static constexpr int col(int i, int tx) {
    return i < 4 * kQ ? 32 * (i / 4) + 4 * tx + i % 4 : 32 * kQ + kR * tx + (i - 4 * kQ);
  }
};

// One float from device to shared memory, zero where `ok` is false (src-size 0 reads nothing).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The copies below give each thread a few base addresses and step from them by constants, so
// that unrolled they hold two or three registers, not one address a copy.  A thread's lane
// bits pick its place in a warp's copy: lo3 = tid & 7, mid = (tid >> 3) & 3, w = tid >> 5.

// The tile's rows of x, transposed: xs[k][r] = x[row0 + r][k], k = lo3 + 8 (n / 8), r = mid +
// 4 w + 16 (n % 8).  A warp's copy takes 8 neighbouring k of 4 rows (4 sectors of device
// memory; banks 4k + r, all distinct).
template <int CPT>
__device__ __forceinline__ void load_x(float* xs, const float* x, int row0, int m, int d,
                                       int tid) {
  const int lo3 = tid & 7, r = ((tid >> 3) & 3) + 4 * (tid >> 5);
  const float* src = x + (size_t)(row0 + r) * d + lo3;
  float* dst = xs + lo3 * kRowStride + r;
#pragma unroll
  for (int n = 0; n < Layout<CPT>::kWidth; ++n) {
    const int dk = 8 * (n / 8), dr = 16 * (n % 8);
    copy4(dst + dk * kRowStride + dr, src + (size_t)dr * d + dk,
          lo3 + dk < d && row0 + r + dr < m);
  }
}

// Chunk h0's weights.  w1s[k][j] = W1[h0 + j][k], k = lo3 + 8 (n / 4), j = mid + 4 w + 16 (n %
// 4): 8 neighbouring k of 4 units a warp copy, banks 4k + j.  w2s[j][c] = W2[c][h0 + j], c =
// mid + 4 (n / 2), j = lo3 + 8 w + 32 (n % 2): 8 neighbouring units of 4 columns, banks 12j + c
// (D 72).  FULL: every unit h0 + j lies below F.
template <int CPT, bool FULL>
__device__ __forceinline__ void load_w1(float* w1s, const float* w1, int h0, int d, int f,
                                        int tid) {
  const int lo3 = tid & 7, j = ((tid >> 3) & 3) + 4 * (tid >> 5);
  const float* src = w1 + (size_t)(h0 + j) * d + lo3;
  float* dst = w1s + lo3 * kChunkStride + j;
#pragma unroll
  for (int n = 0; n < Layout<CPT>::kWidth / 2; ++n) {
    const int dk = 8 * (n / 4), dj = 16 * (n % 4);
    copy4(dst + dk * kChunkStride + dj, src + (size_t)dj * d + dk,
          lo3 + dk < d && (FULL || h0 + j + dj < f));
  }
}

template <int CPT, bool FULL>
__device__ __forceinline__ void load_w2(float* w2s, const float* w2, int h0, int d, int f,
                                        int tid) {
  using L = Layout<CPT>;
  const int mid = (tid >> 3) & 3, j = (tid & 7) + 8 * (tid >> 5);
  const float* src = w2 + (size_t)mid * f + h0 + j;
  float* dst = w2s + j * L::kW2Stride + mid;
#pragma unroll
  for (int n = 0; n < L::kWidth / 2; ++n) {
    const int dc = 4 * (n / 2), dj = 32 * (n % 2);
    copy4(dst + dj * L::kW2Stride + dc, src + (size_t)dc * f + dj,
          mid + dc < d && (FULL || h0 + j + dj < f));
  }
}

template <int CPT>
__device__ __forceinline__ void load_w1(float* w1s, const float* w1, int h0, int d, int f,
                                        int tid) {
  if (h0 + kChunk <= f)
    load_w1<CPT, true>(w1s, w1, h0, d, f, tid);
  else
    load_w1<CPT, false>(w1s, w1, h0, d, f, tid);
}

template <int CPT>
__device__ __forceinline__ void load_w2(float* w2s, const float* w2, int h0, int d, int f,
                                        int tid) {
  if (h0 + kChunk <= f)
    load_w2<CPT, true>(w2s, w2, h0, d, f, tid);
  else
    load_w2<CPT, false>(w2s, w2, h0, d, f, tid);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ void unpack(const float4 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// The LayerNorm statistics of one row whose D values are spread over lanes that differ in the
// lane bits first_bit..last_bit: the sum and the squared deviations reduced by shuffles.
template <int N>
__device__ __forceinline__ void row_stats(const float (&v)[N], const bool (&ok)[N],
                                          int first_bit, int last_bit, int d, float eps,
                                          float& mean, float& inv) {
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) sum += ok[i] ? v[i] : 0.f;
  for (int bit = first_bit; bit <= last_bit; bit <<= 1) sum += __shfl_xor_sync(kFull, sum, bit);
  mean = __fdiv_rn(sum, (float)d);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float dev = __fsub_rn(v[i], mean);
    sq += ok[i] ? __fmul_rn(dev, dev) : 0.f;
  }
  for (int bit = first_bit; bit <= last_bit; bit <<= 1) sq += __shfl_xor_sync(kFull, sq, bit);
  inv = rsqrtf(__fadd_rn(__fdiv_rn(sq, (float)d), eps));
}

// A normalised value scaled and shifted, each operation rounded as PyTorch's separate ones.
__device__ __forceinline__ float affine(float v, float mean, float inv, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), inv), g), b);
}

// DW: the width D as a constant (the published 72), so that every copy's offset is one; 0 for
// any D up to 8 CPT, read from `width`.
template <int CPT, int DW>
__global__ void __launch_bounds__(kThreads, 2)
    ffn_block_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ out,
                     float* __restrict__ part, int m, int width, int f, int chunks_per_split,
                     float eps) {
  using L = Layout<CPT>;
  const int d = DW ? DW : width;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* w1s = xs + L::kXs;
  float* w2s = w1s + L::kW1;
  float* hs = w2s + L::kW2;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = lane & 3, tx = lane >> 2;
  const int r0 = 32 * (tid >> 5) + 8 * ty;  // the thread's first row in the tile
  const int row0 = blockIdx.x * kRows;
  const int n_chunks = (f + kChunk - 1) / kChunk;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  load_x<CPT>(xs, x, row0, m, d, tid);
  load_w1<CPT>(w1s, w1, c_begin * kChunk, d, f, tid);
  load_w2<CPT>(w2s, w2, c_begin * kChunk, d, f, tid);
  commit();
  wait_all();
  __syncthreads();

  float acc[8][CPT];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[r][i] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int j0 = c * kChunk + 8 * tx;
    float bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bias[j] = j0 + j < f ? __ldg(b1 + j0 + j) : 0.f;

    // H = relu(X W1c^T + b1c): rows r0..r0+7, units 8tx..8tx+7 of the chunk.
    float h[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) h[r][j] = 0.f;
#pragma unroll 8  // full unrolling hoists so many loads that registers spill
    for (int k = 0; k < L::kWidth; ++k) {
      float av[8], bv[8];
      unpack(*reinterpret_cast<const float4*>(xs + k * kRowStride + r0), av);
      unpack(*reinterpret_cast<const float4*>(xs + k * kRowStride + r0 + 4), av + 4);
      unpack(*reinterpret_cast<const float4*>(w1s + k * kChunkStride + 8 * tx), bv);
      unpack(*reinterpret_cast<const float4*>(w1s + k * kChunkStride + 8 * tx + 4), bv + 4);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) h[r][j] = fmaf(av[r], bv[j], h[r][j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* dst = hs + (8 * tx + j) * kRowStride + r0;
      *reinterpret_cast<float4*>(dst) =
          make_float4(relu(h[0][j] + bias[j]), relu(h[1][j] + bias[j]),
                      relu(h[2][j] + bias[j]), relu(h[3][j] + bias[j]));
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(relu(h[4][j] + bias[j]), relu(h[5][j] + bias[j]),
                      relu(h[6][j] + bias[j]), relu(h[7][j] + bias[j]));
    }
    // Every warp is done with W1c, and W2c (copied during this chunk's first product) landed:
    // the next chunk's W1 copies during the second product.
    wait_all();
    __syncthreads();
    if (c + 1 < c_end) load_w1<CPT>(w1s, w1, (c + 1) * kChunk, d, f, tid);
    commit();

    // acc += H W2c^T: rows r0..r0+7, the thread's CPT columns.
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      float av[8], bv[CPT];
      unpack(*reinterpret_cast<const float4*>(hs + k * kRowStride + r0), av);
      unpack(*reinterpret_cast<const float4*>(hs + k * kRowStride + r0 + 4), av + 4);
      const float* w2k = w2s + k * L::kW2Stride;
#pragma unroll
      for (int q = 0; q < L::kQ; ++q)
        unpack(*reinterpret_cast<const float4*>(w2k + 32 * q + 4 * tx), bv + 4 * q);
#pragma unroll
      for (int i = 0; i < L::kR; ++i) bv[4 * L::kQ + i] = w2k[32 * L::kQ + L::kR * tx + i];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[r][i] = fmaf(av[r], bv[i], acc[r][i]);
    }
    // Every warp is done with W2c and H, and the next W1 landed: the next W2 copies during the
    // next chunk's first product.
    wait_all();
    __syncthreads();
    if (c + 1 < c_end) load_w2<CPT>(w2s, w2, (c + 1) * kChunk, d, f, tid);
    commit();
  }
  wait_all();

  if (gridDim.y > 1) {  // partial sums; ffn_block_finish runs the epilogue
    float* p = part + (size_t)blockIdx.y * m * d;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = row0 + r0 + r;
      if (row >= m) continue;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int col = L::col(i, tx);
        if (col < d) p[(size_t)row * d + col] = acc[r][i];
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float v[CPT];
    bool ok[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int col = L::col(i, tx);
      ok[i] = col < d;
      v[i] = ok[i] ? __fadd_rn(__fadd_rn(acc[r][i], __ldg(b2 + col)),
                               xs[col * kRowStride + r0 + r])
                   : 0.f;
    }
    float mean, inv;
    row_stats<CPT>(v, ok, 4, 16, d, eps, mean, inv);  // a row's 8 lanes: lane bits 2-4
    const int row = row0 + r0 + r;
    if (row >= m) continue;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int col = L::col(i, tx);
      if (ok[i])
        out[(size_t)row * d + col] = affine(v[i], mean, inv, __ldg(gamma + col), __ldg(beta + col));
    }
  }
}

// The split path's epilogue: a warp a row, its D <= 72 values 3 a lane; the splits' partial
// sums added in split order, then b2, x and the LayerNorm as in the main kernel.
__global__ void ffn_block_finish(const float* __restrict__ part, int splits,
                                 const float* __restrict__ x, const float* __restrict__ b2,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta, float* __restrict__ out,
                                 int m, int d, float eps) {
  constexpr int N = (kMaxWidth + 31) / 32;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;  // a whole warp at once
  float v[N];
  bool ok[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int col = lane + 32 * i;
    ok[i] = col < d;
    v[i] = 0.f;
    if (!ok[i]) continue;
    float s = part[(size_t)row * d + col];
    for (int p = 1; p < splits; ++p) s = __fadd_rn(s, part[((size_t)p * m + row) * d + col]);
    v[i] = __fadd_rn(__fadd_rn(s, b2[col]), x[(size_t)row * d + col]);
  }
  float mean, inv;
  row_stats<N>(v, ok, 1, 16, d, eps, mean, inv);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int col = lane + 32 * i;
    if (ok[i]) out[(size_t)row * d + col] = affine(v[i], mean, inv, gamma[col], beta[col]);
  }
}

// The dynamic shared memory of the instantiation into smem, and its attributes set on `device`
// at the first call there (later calls make no runtime call).
template <int CPT, int DW>
cudaError_t prepare(int device, size_t& smem) {
  static std::atomic<bool> done[kMaxDevices];
  smem = sizeof(float) * Layout<CPT>::kFloats;
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const auto kernel = ffn_block_kernel<CPT, DW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && known) done[device].store(true, std::memory_order_release);
  return err;
}

// The blocks a row tile's hidden is split across: the count from 1 to 16 with the least cost
// in chunk times of one block, on the card's resident blocks (slots): the waves of units (a row
// tile's share of the chunks) times a unit's chunks and half a chunk of set-up (its x tile and
// first weights), plus the partial sums a split writes and the epilogue reads back, about a
// chunk time a unit for each slot.  Ties go to fewer splits.  On the H100 at D 72, F 2048 it
// picks 2 at 46,720 rows, 4 at 23,936 and 11 at 3,072, at each the fastest of the counts timed
// there (1, 2, 4, 6, 11, 16; 2 and 6 tie at 46,720).
template <int CPT, int DW>
cudaError_t choose_splits(int m, int f, int device, int& splits) {
  size_t smem;
  cudaError_t err = prepare<CPT, DW>(device, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ffn_block_kernel<CPT, DW>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)max(per_sm, 1) * sms;
  const long long tiles = (m + kRows - 1) / kRows;
  const int n_chunks = (f + kChunk - 1) / kChunk;
  double best = -1.0;
  for (int s = 1; s <= min(kMaxSplits, n_chunks); ++s) {
    const int per = (n_chunks + s - 1) / s;
    if ((n_chunks + per - 1) / per != s) continue;  // the same units as fewer splits
    const long long units = tiles * s;
    const double cost = (double)((units + slots - 1) / slots) * (per + 0.5) +
                        (s > 1 ? (double)units / slots : 0.0);
    if (best < 0.0 || cost < best) {
      best = cost;
      splits = s;
    }
  }
  return cudaSuccess;
}

template <int CPT, int DW>
cudaError_t launch(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* gamma, const float* beta, float* out,
                   float* part, int m, int d, int f, int splits, float eps, int device,
                   cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare<CPT, DW>(device, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (f + kChunk - 1) / kChunk;
  const int per_split = (n_chunks + splits - 1) / splits;
  splits = (n_chunks + per_split - 1) / per_split;  // no split without a chunk
  const dim3 grid((m + kRows - 1) / kRows, splits);
  ffn_block_kernel<CPT, DW><<<grid, kThreads, smem, stream>>>(x, w1, b1, w2, b2, gamma, beta, out,
                                                          part, m, d, f, per_split, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int warps_per_block = kThreads / 32;
  ffn_block_finish<<<(m + warps_per_block - 1) / warps_per_block, kThreads, 0, stream>>>(
      part, splits, x, b2, gamma, beta, out, m, d, eps);
  return cudaGetLastError();
}

}  // namespace

// The split count fdtpu_ffn_block should be given for M rows of width D and hidden F on
// `device`, into *splits.  Returns a cudaError_t (0 = success).
extern "C" int fdtpu_ffn_block_splits(int m, int d, int f, int device, int* splits) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (m < 1 || f < 1 || d < 1 || d > kMaxWidth) return (int)cudaErrorInvalidValue;
  if (d == kMaxWidth) return (int)choose_splits<9, kMaxWidth>(m, f, device, *splits);
  if (d <= 32) return (int)choose_splits<4, 0>(m, f, device, *splits);
  return (int)choose_splits<9, 0>(m, f, device, *splits);
}

// `part` holds `splits` x M x D floats when splits > 1 (else it is not read).  `device` is the
// CUDA ordinal the tensors live on.  Returns the cudaError_t of the launches (0 = success).
// The caller checks shapes, dtypes, contiguity and 1 <= D <= 72 beforehand.
extern "C" int fdtpu_ffn_block(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* gamma, const void* beta, void* out,
                               void* part, int m, int d, int f, int splits, float eps,
                               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (m < 1 || f < 1 || splits < 1 || splits > kMaxSplits || d < 1 || d > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* w2f = static_cast<const float*>(w2);
  const auto* b2f = static_cast<const float*>(b2);
  const auto* gf = static_cast<const float*>(gamma);
  const auto* bf = static_cast<const float*>(beta);
  auto* of = static_cast<float*>(out);
  auto* pf = static_cast<float*>(part);
  if (d == kMaxWidth)
    return (int)launch<9, kMaxWidth>(xf, w1f, b1f, w2f, b2f, gf, bf, of, pf, m, d, f, splits,
                                     eps, device, s);
  if (d <= 32)
    return (int)launch<4, 0>(xf, w1f, b1f, w2f, b2f, gf, bf, of, pf, m, d, f, splits, eps,
                             device, s);
  return (int)launch<9, 0>(xf, w1f, b1f, w2f, b2f, gf, bf, of, pf, m, d, f, splits, eps,
                           device, s);
}
