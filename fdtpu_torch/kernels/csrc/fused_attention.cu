// Fused multi-head attention over the token-major (B, T, H, Dh) layout, for Hopper (sm_90a):
// kernel B4.
//
// Replaces the Pallas TPU kernel `fused_mha` (fdtpu/kernels/attention.py, `_mha_kernel`).
// Contract, per batch element b and head h:
//
//     out[b, :, h, :] = softmax(q[b, :, h, :] k[b, :, h, :]^T / sqrt(Dh)) v[b, :, h, :]
//
// with q (B, Tq, H, Dh), k and v (B, Tk, H, Dh), out (B, Tq, H, Dh), all in one type (float32
// or bfloat16).  Scores are float32; the true row max (no padding) is subtracted before exp;
// the weights are divided by the row sum in float32 (>= 1 after the shift, so no clamp) and
// rounded to v's type before the value product, whose sum is float32.  Tq may differ from
// Tk: the token level attends `token_budget` query rows to all T keys.  No gradient.
//
// What bounds it on an H100.  At the KV level's square shape (B=128, Tq=Tk=187, H=12,
// Dh=6) one call does 4*B*H*Tq*Tk*Dh = 1.29 GFLOP and B*H*Tq*Tk = 53.7M exps on 27.6 MB of
// q/k/v/out in float32 (13.8 MB in bfloat16).  float32: operations bound it, the CUDA
// cores' FMA pipe (20 us at 67 TFLOP/s).  bfloat16: bytes bound it (4.1 us), and above the
// bytes the MUFU pipe's exps, 16 a clock an SM (~15 us at the flagship's 53.7M).  At the
// token level's TOPK shape (Tq = 24 rows against Tk = 187) both types are bytes-bound
// (4.6 / 2.3 us).  The first design, a warp per (query row, head) with the lanes over the
// keys, shuffle reductions and two or three passes over the keys, took 0.405 / 0.484 ms at
// the square shape (PERF.md).
//
// float32: B1's design (blockdiag_common.cuh).  A thread owns R query rows of one head (two
// at Dh 6 where that takes fewer warps than one, so the token level's 24 rows keep one a
// thread) with q pre-scaled by log2(e)/sqrt(Dh), the running max, sum and Dh accumulators
// in registers.  The keys stream through 16 KB tiles of [k | v] records a head (256 keys at
// Dh <= 8), read as broadcast 16-byte vectors, through the online softmax in chunks of C
// keys on ex2.approx.ftz; one pass, no shuffles, the division by the row sum at the end (the
// rounding of the weights to float32 is the identity).  A block covers all the rows of a
// head (96 threads at Tq = 187) and as many heads as fill 128 threads (4 at the token
// level's 24 rows), so K and V are staged once per (batch, head).  A key row of a head is
// Dh values H*Dh apart from the next, so the staging maps neighbouring lanes to
// neighbouring elements of the block's heads' rows: every load is coalesced.
//
// bfloat16: warp-level tensor-core tiles, mma.sync.m16n8k16 (bf16 in, float32 sums).  A
// warp owns 16 query rows of one head; a block holds up to 4 warps of one head, which take
// its 16-row tiles in turn (all 12 of Tq = 187), and stages the head's K as rows [Tk][Dh
// padded to 16 or 32] and V transposed [Dh padded to 8, 16 or 32][Tk] in shared memory,
// once (every key, up to 64 KB), with coalesced loads as above; row strides of 4 mod 8
// words make each fragment load hit 32 distinct banks.  S = Q K^T comes out of the tensor
// cores in float32 (bf16 products are exact in float32) from Q's fragments held in
// registers, unscaled: q stays in bfloat16, and log2(e)/sqrt(Dh) is applied to the float32
// scores in the exp2's FMA.  The contract rounds the normalised weights, so the row's max
// and sum must be known before the value product: the warp keeps its 16 x Tk scores in
// registers (a register tile of 192 keys, the chains' Tk = 187: 96 floats a thread),
// takes the row max and sum across the quad of lanes that share a row (two shuffles each),
// normalises, rounds to bf16 and reuses the score accumulators as the A fragments of
// O = P V (FlashAttention-2's C-to-A fragment layout): one exp a pair.  Every score tile is
// computed, masked past Tk, with no branch around it, so a phase's loads, products and exps
// schedule as one block of code (a branch around each tile split them apart, and was
// slower).  Past 192 keys a first pass keeps an online max and sum over register tiles of
// 256 and a second recomputes S for the value product (two exps a pair); past 64 KB of
// keys the stages are loaded anew in each pass.
//
// Deterministic: each output is summed by one thread (float32) or by one fixed sequence of
// mma instructions (bfloat16).
//
// Built with nvcc into a shared library with a plain C interface (loaded with ctypes);
// the kernel runs on the caller's stream, does not synchronize and allocates nothing.

#include "blockdiag_common.cuh"

#include <stdint.h>

namespace {

constexpr int kMinThreads = 128;  // float32: heads a block until it has this many threads
constexpr int kMmaWarps = 4;      // bfloat16: 16-row warps of one head a block, at most
constexpr int kBlockTiles = 16;   // bfloat16: 16-row tiles of one head a block, at most
constexpr size_t kStageBytes = 64 * 1024;  // bfloat16: shared memory of the staged keys, at most

// One call's operands and shapes.
struct Call {
  const void *q, *k, *v;
  void* out;
  int batch, q_len, kv_len, n_head, head_dim;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Zero n 16-byte words of shared memory.
__device__ __forceinline__ void zero_smem(float4* p, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The lanes of a warp over the elements of `width`-wide rows: rows a warp covers at once
// (32 / width, at least 1), this lane's row among them and its first column.
struct RowLanes {
  int rows, row, col;
  __device__ __forceinline__ RowLanes(int width) {
    const int lane = threadIdx.x % 32;
    rows = max(1, 32 / width);
    row = width >= 32 ? 0 : lane / width;
    col = width >= 32 ? lane : lane % width;
  }
};

// ---------------------------------------------------------------------------------------
// float32

// Stage n key rows of a group of heads (k, v at the group's first column of key 0, rows
// d_model apart; width = heads * head_dim columns): element d of head i's key j goes to
// record j of head i (keys + (i * stride + j) * E + d, and v's at + SD).  Neighbouring lanes
// read neighbouring columns of a row, so every load instruction is coalesced.
template <int DH>
__device__ __forceinline__ void stage_f32(float* keys, int stride, const float* k,
                                          const float* v, int n, int width, int head_dim,
                                          int d_model) {
  constexpr int SD = Width<DH>::SD, E = Width<DH>::E;
  const RowLanes lanes(width);
  if (lanes.row >= lanes.rows) return;
  const int warps = blockDim.x / 32, step = warps * lanes.rows;
  for (int c = lanes.col; c < width; c += 32) {
    const int i = c / head_dim, d = c - i * head_dim;
    float* dst = keys + (size_t)i * stride * E + d;
#pragma unroll 4
    for (int j = threadIdx.x / 32 * lanes.rows + lanes.row; j < n; j += step) {
      const size_t at = (size_t)j * d_model + c;
      dst[(size_t)j * E] = k[at];
      dst[(size_t)j * E + SD] = v[at];
    }
  }
}

template <int DH, int R>
__global__ void __launch_bounds__(kMaxThreads)
    fused_mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int q_len,
                         int kv_len, int n_head, int head_dim, int group, float q_scale) {
  constexpr int C = Width<DH>::C, E = Width<DH>::E;
  constexpr int KT = tile<DH>();
  extern __shared__ float4 smem4[];
  float* keys = reinterpret_cast<float*>(smem4);

  const int per_head = blockDim.x / group;  // threads of one head, a multiple of 32
  const int hh = threadIdx.x / per_head;
  const int h0 = blockIdx.y * group;
  const int heads = min(group, n_head - h0);
  const bool active = hh < heads;          // the last group of heads may be short
  const int h = h0 + min(hh, heads - 1);
  const int b = blockIdx.z;
  const int d_model = n_head * head_dim;
  const int row0 = blockIdx.x * per_head * R + threadIdx.x % per_head;

  float qr[R][DH], acc[R][DH], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(row0 + r * per_head, q_len - 1);
    const float* qrow = q + ((size_t)b * q_len + row) * d_model + (size_t)h * head_dim;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qr[r][d] = d < head_dim ? qrow[d] * q_scale : 0.f;
      acc[r][d] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  // Head i's records at keys + i * stride * E, the same place in every tile, so the
  // zero padding of the records (past head_dim) is written once.
  const int stride = min(kv_len, KT);
  zero_smem(smem4, (size_t)group * stride * E / 4);
  __syncthreads();
  const size_t kv0 = (size_t)b * kv_len * d_model + (size_t)h0 * head_dim;
  for (int j0 = 0; j0 < kv_len; j0 += KT) {
    const int n = min(KT, kv_len - j0);
    if (j0 > 0) __syncthreads();  // every thread is done with the previous tile
    stage_f32<DH>(keys, stride, k + kv0 + (size_t)j0 * d_model, v + kv0 + (size_t)j0 * d_model,
                  n, heads * head_dim, head_dim, d_model);
    __syncthreads();
    if (active) attend_tile<DH, R, C, true>(keys + (size_t)hh * stride * E, n, qr, acc, m, l);
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * per_head;
    if (row >= q_len) continue;
    float* orow = out + ((size_t)b * q_len + row) * d_model + (size_t)h * head_dim;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < head_dim) orow[d] = acc[r][d] / l[r];
  }
}

template <int DH, int R>
cudaError_t launch_f32(const Call& c) {
  // The fewest warps that give every thread R rows of a head, up to kMaxThreads (then row
  // tiles), and heads a block up to kMinThreads threads.
  const int per_head = min(kMaxThreads, ((c.q_len + R - 1) / R + 31) / 32 * 32);
  const int group = max(1, min(c.n_head, kMinThreads / per_head));
  const int rows = per_head * R;
  const size_t smem = sizeof(float) * Width<DH>::E * (size_t)group * min(c.kv_len, tile<DH>());
  auto kernel = fused_mha_f32_kernel<DH, R>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c.q_len + rows - 1) / rows, (c.n_head + group - 1) / group, c.batch);
  const float q_scale = kLog2e / sqrtf((float)c.head_dim);
  kernel<<<grid, per_head * group, smem, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<float*>(c.out), c.q_len, c.kv_len, c.n_head,
      c.head_dim, group, q_scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t rows_f32(const Call& c) {
  // Width<DH>::R rows a thread only where that takes fewer warps than one row a thread.
  if constexpr (Width<DH>::R > 1) {
    constexpr int R = Width<DH>::R;
    if (((c.q_len + R - 1) / R + 31) / 32 < (c.q_len + 31) / 32) return launch_f32<DH, R>(c);
  }
  return launch_f32<DH, 1>(c);
}

// ---------------------------------------------------------------------------------------
// bfloat16

// DV, head_dim padded to the value product's n (8, 16 or 32); KS k-steps of 16 in the
// score product, DK = 16 * KS the staged width of K, NV n-tiles of 8 in the value product;
// KSTR the staged K row in bf16 (DK + 8: 12 or 20 words, 4 mod 8).
template <int DV>
struct MmaWidth {
  static constexpr int KS = DV <= 16 ? 1 : 2;
  static constexpr int DK = 16 * KS;
  static constexpr int NV = DV / 8;
  static constexpr int KSTR = DK + 8;
};

// Bytes of shared memory of a stage of `keys` keys (a multiple of 16): K rows and V
// transposed, rows of keys + 8 (4 mod 8 words, so fragment loads hit 32 distinct banks).
template <int DV>
__host__ __device__ __forceinline__ size_t stage_bytes(int keys) {
  return sizeof(__nv_bfloat16) * ((size_t)keys * MmaWidth<DV>::KSTR + DV * (size_t)(keys + 8));
}

// D = A B + D for one m16n8k16 tile: A 16x16 bf16 (row), B 16x8 bf16 (col), D float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even) in one register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t pack_bits(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Max and sum over the quad of lanes that hold one row's columns.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage keys [j0, j0 + n) of one head (k, v at its token 0): ks[j][d] = k_j[d] and
// vt[d][j] = v_j[d] (rows vstr apart).  Neighbouring lanes read neighbouring elements of a
// key row (and the next rows), so every load instruction is coalesced.  The padding (past
// head_dim, and past the keys of a short last stage) holds zeros from the start or finite
// values of an earlier stage: the masked keys' weights are 0, which keeps the value
// product exact.
__device__ __forceinline__ void stage_kv(__nv_bfloat16* ks, int kstr, __nv_bfloat16* vt,
                                         int vstr, const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, int j0, int n, int head_dim,
                                         int d_model) {
  const RowLanes lanes(head_dim);
  if (lanes.row >= lanes.rows) return;
  const int d = lanes.col, step = blockDim.x / 32 * lanes.rows;
#pragma unroll 4
  for (int j = threadIdx.x / 32 * lanes.rows + lanes.row; j < n; j += step) {
    const size_t at = (size_t)(j0 + j) * d_model + d;
    ks[j * kstr + d] = k[at];
    vt[d * vstr + j] = v[at];
  }
}

// The warp's raw scores against KT * 8 staged keys, n of them real: s[nt] is the C
// fragment of keys 8 nt .. 8 nt + 7 (rows g, g + 8; columns 2t, 2t + 1); keys past n are
// -inf.  No branch around a tile, so the loads and products of all tiles schedule together.
template <int DV, int KT>
__device__ __forceinline__ void scores(float (&s)[KT][4],
                                       const uint32_t (&qa)[MmaWidth<DV>::KS][4],
                                       const __nv_bfloat16* ks, int n, int g, int t) {
  constexpr int KS = MmaWidth<DV>::KS, KSTR = MmaWidth<DV>::KSTR;
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const __nv_bfloat16* kr = ks + (nt * 8 + g) * KSTR + 2 * t;
#pragma unroll
    for (int kq = 0; kq < KS; ++kq)
      mma_bf16(s[nt], qa[kq], load_pair(kr + 16 * kq), load_pair(kr + 16 * kq + 8));
    const int j = nt * 8 + 2 * t;
    if (j >= n) s[nt][0] = s[nt][2] = -INFINITY;
    if (j + 1 >= n) s[nt][1] = s[nt][3] = -INFINITY;
  }
}

// s = exp2(s * scale - mc) against the row's scaled max mc, summed into l (one add a pair
// of columns into each row's sum).
template <int KT>
__device__ __forceinline__ void exps(float (&s)[KT][4], const float (&mc)[2], float (&l)[2],
                                     float scale) {
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = exp2_<true>(fmaf(s[nt][e], scale, -mc[e / 2]));
    l[0] += s[nt][0] + s[nt][1];
    l[1] += s[nt][2] + s[nt][3];
  }
}

// One register tile's scores into the online max m and the thread's part of the sum l of
// its two rows: s becomes exp2(s * scale - m * scale) against the new max.
template <int KT>
__device__ __forceinline__ void online(float (&s)[KT][4], float (&m)[2], float (&l)[2],
                                       float scale) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    mc[r] = mx[r] * scale;
    l[r] *= exp2_<true>(m[r] * scale - mc[r]);  // 0 on the first tile (m = -inf)
    m[r] = mx[r];
  }
  exps(s, mc, l, scale);
}

// O += round_bf16(P * inv) V over KT * 8 staged keys (V^T rows vstr apart): score tiles 2kk
// and 2kk + 1 are the A fragment of k-step kk (FlashAttention-2's C-to-A layout).
template <int DV, int KT>
__device__ __forceinline__ void values(float (&o)[MmaWidth<DV>::NV][4],
                                       const float (&p)[KT][4], const float (&inv)[2],
                                       const __nv_bfloat16* vt, int vstr, int g, int t) {
  constexpr int NV = MmaWidth<DV>::NV;
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0] * inv[0], p[2 * kk][1] * inv[0]),
                           pack_bf16(p[2 * kk][2] * inv[1], p[2 * kk][3] * inv[1]),
                           pack_bf16(p[2 * kk + 1][0] * inv[0], p[2 * kk + 1][1] * inv[0]),
                           pack_bf16(p[2 * kk + 1][2] * inv[1], p[2 * kk + 1][3] * inv[1])};
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const __nv_bfloat16* vr = vt + (nv * 8 + g) * vstr + kk * 16 + 2 * t;
      mma_bf16(o[nv], a, load_pair(vr), load_pair(vr + 8));
    }
  }
}

// Element d of q's row `row` of head h, zero past q_len and head_dim.
__device__ __forceinline__ __nv_bfloat16 q_at(const __nv_bfloat16* q, int row, int d, int q_len,
                                              int head_dim, int d_model) {
  return row < q_len && d < head_dim ? q[(size_t)row * d_model + d] : __float2bfloat16(0.f);
}

template <int DV, int KT>
__global__ void __launch_bounds__(kMmaWarps * 32, KT <= 24 && DV <= 16 ? 3 : 2)
    fused_mha_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          int q_len, int kv_len, int n_head, int head_dim, int block_tiles,
                          int staged, float scale) {
  using W = MmaWidth<DV>;
  constexpr int NK = KT * 8;  // keys of a register tile
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* vt = ks + (size_t)staged * W::KSTR;
  const int vstr = staged + 8;

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warps = blockDim.x / 32, w = threadIdx.x / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int d_model = n_head * head_dim;
  const __nv_bfloat16* qh = q + (size_t)b * q_len * d_model + (size_t)h * head_dim;
  const __nv_bfloat16* kh = k + (size_t)b * kv_len * d_model + (size_t)h * head_dim;
  const __nv_bfloat16* vh = v + (size_t)b * kv_len * d_model + (size_t)h * head_dim;
  // The block's 16-row tiles [tile0, tile_end), warp w taking tile0 + w, + warps, ...
  const int tile0 = blockIdx.x * block_tiles;
  const int tile_end = min(tile0 + block_tiles, (q_len + 15) / 16);
  const int rounds = (tile_end - tile0 + warps - 1) / warps;
  // Register tiles of NK keys; a stage holds `staged` keys (a multiple of NK): all of them,
  // staged once, unless they overflow it; then the stages are staged anew in each pass.
  const int key_tiles = (kv_len + NK - 1) / NK;
  const int per_stage = staged / NK;
  const bool restage = kv_len > staged;
  zero_smem(smem4, stage_bytes<DV>(staged) / 16);
  __syncthreads();
  if (!restage) {
    stage_kv(ks, W::KSTR, vt, vstr, kh, vh, 0, kv_len, head_dim, d_model);
    __syncthreads();
  }
  for (int round = 0; round < rounds; ++round) {
    const int r0 = (tile0 + round * warps + w) * 16;
    const bool active = r0 < tile_end * 16;  // warp-uniform
    // Q's A fragments: rows r0 + g (+ 8), columns 16 kq + 2t (+ 1, + 8, + 9), zero-padded.
    uint32_t qa[W::KS][4];
#pragma unroll
    for (int kq = 0; kq < W::KS; ++kq) {
      const int c = 16 * kq + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e % 2), col = c + 8 * (e / 2);
        qa[kq][e] = pack_bits(q_at(qh, row, col, q_len, head_dim, d_model),
                              q_at(qh, row, col + 1, q_len, head_dim, d_model));
      }
    }

    float s[KT][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    // Pass 1: the row max and sum, online across register tiles; with one tile, s keeps
    // the exps for the value product.
    for (int i = 0; i < key_tiles; ++i) {
      if (restage && i % per_stage == 0) {  // block-uniform: a new stage every per_stage tiles
        __syncthreads();                    // every warp is done with the previous stage
        stage_kv(ks, W::KSTR, vt, vstr, kh, vh, i * NK, min(staged, kv_len - i * NK),
                 head_dim, d_model);
        __syncthreads();
      }
      if (active) {
        const int at = i % per_stage * NK;
        scores<DV, KT>(s, qa, ks + (size_t)at * W::KSTR, kv_len - i * NK, g, t);
        online<KT>(s, m, l, scale);
      }
    }
    float inv[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv[r] = active ? 1.f / quad_sum(l[r]) : 0.f;
      mc[r] = m[r] * scale;
    }
    float o[W::NV][4];
#pragma unroll
    for (int nv = 0; nv < W::NV; ++nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nv][e] = 0.f;
    if (key_tiles == 1) {
      if (active) values<DV, KT>(o, s, inv, vt, vstr, g, t);
    } else {
      // Pass 2: the same scores again, exp2 against the final max, the value product.
      for (int i = 0; i < key_tiles; ++i) {
        if (restage && i % per_stage == 0) {
          __syncthreads();
          stage_kv(ks, W::KSTR, vt, vstr, kh, vh, i * NK, min(staged, kv_len - i * NK),
                   head_dim, d_model);
          __syncthreads();
        }
        if (active) {
          const int at = i % per_stage * NK;
          float unused[2] = {0.f, 0.f};
          scores<DV, KT>(s, qa, ks + (size_t)at * W::KSTR, kv_len - i * NK, g, t);
          exps<KT>(s, mc, unused, scale);
          values<DV, KT>(o, s, inv, vt + at, vstr, g, t);
        }
      }
    }
    if (!active) continue;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      if (row >= q_len) continue;
      __nv_bfloat16* orow = out + ((size_t)b * q_len + row) * d_model + (size_t)h * head_dim;
#pragma unroll
      for (int nv = 0; nv < W::NV; ++nv) {
        const int d = nv * 8 + 2 * t;
        if (d < head_dim) orow[d] = __float2bfloat16(o[nv][2 * half]);
        if (d + 1 < head_dim) orow[d + 1] = __float2bfloat16(o[nv][2 * half + 1]);
      }
    }
  }
}

template <int DV, int KT>
cudaError_t launch_bf16(const Call& c) {
  // A stage holds every key, in whole register tiles, up to kStageBytes of shared memory.
  constexpr int NK = KT * 8;
  const int fit = max(NK, (int)(kStageBytes / stage_bytes<DV>(NK)) * NK);
  const int staged = min(fit, (c.kv_len + NK - 1) / NK * NK);
  const size_t smem = stage_bytes<DV>(staged);
  auto kernel = fused_mha_bf16_kernel<DV, KT>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // A block per (b, h) and up to kBlockTiles 16-row tiles (spread evenly), so K and V are
  // staged once for them.  Up to kMmaWarps warps take a block's tiles in turn.
  const int row_tiles = (c.q_len + 15) / 16;
  const int blocks = (row_tiles + kBlockTiles - 1) / kBlockTiles;
  const int block_tiles = (row_tiles + blocks - 1) / blocks;
  const dim3 grid(blocks, c.n_head, c.batch);
  const float scale = kLog2e / sqrtf((float)c.head_dim);
  kernel<<<grid, min(kMmaWarps, block_tiles) * 32, smem, c.stream>>>(
      static_cast<const __nv_bfloat16*>(c.q), static_cast<const __nv_bfloat16*>(c.k),
      static_cast<const __nv_bfloat16*>(c.v), static_cast<__nv_bfloat16*>(c.out), c.q_len,
      c.kv_len, c.n_head, c.head_dim, block_tiles, staged, scale);
  return cudaGetLastError();
}

template <int DV>
cudaError_t keys_bf16(const Call& c) {
  // Every key in one register tile of 24 score tiles of 8 keys (the chains' Tk = 187);
  // past 192 keys, register tiles of 256 in two passes.
  if (c.kv_len <= 192) return launch_bf16<DV, 24>(c);
  return launch_bf16<DV, 32>(c);
}

cudaError_t dispatch(int dtype, const Call& c) {
  if (dtype == 0) {
    if (c.head_dim <= 6) return rows_f32<6>(c);
    if (c.head_dim <= 8) return rows_f32<8>(c);
    if (c.head_dim <= 16) return rows_f32<16>(c);
    if (c.head_dim <= 32) return rows_f32<32>(c);
  } else if (dtype == 1) {
    if (c.head_dim <= 8) return keys_bf16<8>(c);
    if (c.head_dim <= 16) return keys_bf16<16>(c);
    if (c.head_dim <= 32) return keys_bf16<32>(c);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `device` is the CUDA ordinal the tensors live on.
// Returns the cudaError_t of the launch (0 = success).  The caller checks shapes,
// contiguity and the key ceiling beforehand.
extern "C" int fdtpu_fused_mha_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int batch, int q_len, int kv_len, int n_head,
                                   int head_dim, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Call c{q, k, v, out, batch, q_len, kv_len, n_head, head_dim,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, c);
}
