// What the float32 attention kernels B1 (blockdiag_attention.cu), B2
// (blockdiag_attention_bwd.cu) and B4's float32 path (fused_attention.cu) share: the
// compute widths, the staged record layout in shared memory, its vector loads, the dot
// product, exp2 and the chunked online softmax of B1 and B4.
//
// A staged record is two halves of SD floats, [a_0..a_{Dh-1}, 0.. | b_0..b_{Dh-1}, 0..]
// (k | v for keys, q | g for rows), SD the compute width DH rounded up to 4, so that a
// warp reads a record as broadcasts of 16-byte vectors; the zero padding keeps the padded
// lanes of every dot product at 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTileBytes = 16 * 1024;  // shared memory of one tile of records
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Compute width DH (6, 8, 16 or 32; head_dim <= DH, the rest zero), its padded width SD,
// the floats E of a record, the query rows R a B1 thread owns and the keys C per
// online-softmax rescale.  R = 2 only at DH = 6, the flagship's width, where it measured
// 8% faster than one row on the H100 with no spills in float32 (PERF.md); the wider
// widths keep one row.
template <int DH>
struct Width {
  static constexpr int SD = (DH + 3) / 4 * 4;
  static constexpr int E = 2 * SD;
  static constexpr int R = DH == 6 ? 2 : 1;
  static constexpr int C = DH <= 8 ? 8 : (DH <= 16 ? 4 : 2);
};

// Records in one tile.
template <int DH>
__host__ __device__ constexpr int tile() { return kTileBytes / (Width<DH>::E * 4); }

// DH floats from shared memory (16-byte aligned) as 16- and 8-byte vectors.
template <int DH>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[DH]) {
#pragma unroll
  for (int d = 0; d + 4 <= DH; d += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + d);
    x[d] = t.x, x[d + 1] = t.y, x[d + 2] = t.z, x[d + 3] = t.w;
  }
  if constexpr (DH % 4 == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p + DH - 2);
    x[DH - 2] = t.x, x[DH - 1] = t.y;
  }
}

template <int DH>
__device__ __forceinline__ float dot(const float (&a)[DH], const float (&b)[DH]) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// 2^x on the MUFU unit.  With FTZ, results under 2^-126 are flushed to 0, which drops
// exp2f's denormal fix-up; it is used only for x relative to the row max, where a flushed
// weight is under 2^-126 of the largest one.
template <bool FTZ>
__device__ __forceinline__ float exp2_(float x) {
  if constexpr (FTZ) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return exp2f(x);
  }
}

// Stage n records, record i = [a_i * a_scale | b_i], where element d of a_i is at
// a + i * a_i + d * a_d (and likewise b), zero beyond head_dim; a thread per record.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* buf, int n, int head_dim, const T* a, size_t a_i,
                                      size_t a_d, float a_scale, const T* b, size_t b_i,
                                      size_t b_d) {
  constexpr int SD = Width<DH>::SD, E = Width<DH>::E;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float rec[E];
#pragma unroll
    for (int d = 0; d < SD; ++d) {
      rec[d] = d < head_dim ? load_f32(a + i * a_i + d * a_d) * a_scale : 0.f;
      rec[SD + d] = d < head_dim ? load_f32(b + i * b_i + d * b_d) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < E; c += 4)
      *reinterpret_cast<float4*>(buf + (size_t)i * E + c) =
          make_float4(rec[c], rec[c + 1], rec[c + 2], rec[c + 3]);
  }
}

// C keys (records at `rec`) into the online softmax of R rows: m the running max and l
// the running sum of exp2(s - m), in the exp2 units of q pre-scaled by log2(e)/sqrt(Dh).
template <int DH, int R, int C, bool SHIFT>
__device__ __forceinline__ void attend(const float* rec, const float (&qr)[R][DH],
                                       float (&acc)[R][DH], float (&m)[R], float (&l)[R]) {
  constexpr int SD = Width<DH>::SD, E = Width<DH>::E;
  float s[R][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float kc[DH];
    load_vec<DH>(rec + c * E, kc);
#pragma unroll
    for (int r = 0; r < R; ++r) s[r][c] = dot<DH>(qr[r], kc);
  }
  if constexpr (SHIFT) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < C; ++c) mx = fmaxf(mx, s[r][c]);
      const float corr = exp2_<true>(m[r] - mx);  // 0 on the first chunk (m = -inf)
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[r][d] *= corr;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float vc[DH];
    load_vec<DH>(rec + c * E + SD, vc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = exp2_<SHIFT>(s[r][c] - m[r]);
      l[r] += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[r][d] = fmaf(p, vc[d], acc[r][d]);
    }
  }
}

// The n staged keys at `keys` into the online softmax of R rows.
template <int DH, int R, int C, bool SHIFT>
__device__ __forceinline__ void attend_tile(const float* keys, int n, const float (&qr)[R][DH],
                                            float (&acc)[R][DH], float (&m)[R], float (&l)[R]) {
  constexpr int E = Width<DH>::E;
  int j = 0;
  for (; j + C <= n; j += C) attend<DH, R, C, SHIFT>(keys + (size_t)j * E, qr, acc, m, l);
  for (; j < n; ++j) attend<DH, R, 1, SHIFT>(keys + (size_t)j * E, qr, acc, m, l);
}

}  // namespace
