// The E2-CRF score level's reverse step, for Hopper (sm_90a): three kernels that take the place
// of the per-step segments of the resident chain at the score level with the Taylor predictor
// (fdtpu_torch/sampling/resident.py, `Chain`; bound in fdtpu_torch/kernels/chain_step.py).
//
// Replaces no TPU kernel.  The JAX package writes these steps as jnp ops that XLA fuses inside
// `lax.scan` / `lax.cond` (fdtpu/sampling/sampler.py, `score_level_body`).  In the port they were
// eager PyTorch ops captured node by node into the chain's CUDA graph: 82 kernel nodes a skipped
// step (the decision 16, the skip branch 28, the update 36, the 2 conditional setters).  What
// bounds such a step on an H100 is the latency of dependent graph nodes, not bytes or
// operations: it moves five (B, T, C) float32 tensors (x, the score, the noise, eps_hat,
// eps_prev: 0.48 MB at the flagship's B 128, T 187, C 1, under a microsecond at 3.35 TB/s and
// held in L2) and does a few dozen float operations an element.  So the design is one launch a
// segment, and a skipped step is 5 kernel nodes:
//
//   score_pre   one thread: `score_skip_decision` (the step since the last refresh, the
//               calibration step, err_acc >= tau_0 or, with auto_calibrate, >= tau_0 /
//               max(1, overrun), R expired, a cold cache), then what `Chain._set_mode` writes:
//               the step's mode, the branch (mode * (1 + cold)), modes[i] and the branch's run
//               count in the clock;
//   score_skip  a thread an element of (B, T, C): the Taylor prediction of eps_hat at order 0,
//               1 or 2 (`eps_predict`, the same guards on the gaps) at `since + 1` steps ahead,
//               the marginal std of the step's time, score = -prediction / std; one thread
//               adds the drift rate to err_acc;
//   score_post  a thread an element: the Euler-Maruyama update of x (VP or VE, `SDE.step`) from
//               the score, the step's time ts[i] and noise[i]; then the score level's counters
//               (`count_mode`), step + 1 and i + 1.  Every block reads i before the counters
//               move, so they are moved by the last block to finish: each block takes a ticket
//               from `done` after its threads have read i, the block with the last ticket
//               updates the clock and puts `done` back to 0 for the next launch.
//
// Everything is read on the device (the clock, the mode, the cache's scalars, ts, G, the noise),
// so the kernels capture into the chain's graph and the host reads nothing.  The arithmetic is
// the PyTorch composition's, operation by operation in its order and in float32, so that the
// samples and every decision are PyTorch's bit for bit: products, sums and quotients through the
// __f*_rn intrinsics (never contracted into an FMA, as PyTorch's one-operation kernels never
// contract across operations); expf, powf and sqrt as PyTorch's CUDA kernels call them; a
// Python scalar of the composition enters as PyTorch casts it, a float32 computed by the wrapper.
// The counters are int64 as the clock is.  Every function returns its launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

// The chain's int64 clock: [i, step, last_full_step, cold, recompute_count, cache_hit_count,
// full_steps, mixed_steps, cached_steps, runs of branch 0, ...] (`resident.RUNS` = 9).
constexpr int kI = 0, kStep = 1, kLastFull = 2, kCold = 3, kRecompute = 4, kHits = 5, kFull = 6,
              kMixed = 7, kCached = 8, kRuns = 9;
constexpr int kVP = 0;  // the scheduler's kind; 1 is VE
constexpr int kThreads = 256;

// torch.clamp(v, min=1.0): NaN stays NaN.
__device__ __forceinline__ float clamp_min1(float v) { return isnan(v) ? v : fmaxf(v, 1.0f); }

// The marginal std of VP or VE at time t for a token whose noise scaling is g
// (`VPScheduler.marginal_prob`: sqrt(1 - exp(2 log_mean_coeff(t))) g, log_mean_coeff(t) =
// -0.25 t^2 (beta_max - beta_min) - 0.5 t beta_min; `VEScheduler`: sigma_min ratio^t g).
// VP: a = beta_min, b = beta_max - beta_min; VE: a = sigma_min, b = sigma_max / sigma_min.
__device__ __forceinline__ float marginal_std(int kind, float a, float b, float t, float g) {
  if (kind == kVP) {
    const float quadratic = __fmul_rn(__fmul_rn(__fmul_rn(t, t), -0.25f), b);
    const float linear = __fmul_rn(__fmul_rn(t, 0.5f), a);
    const float log_mean_coeff = __fsub_rn(quadratic, linear);
    const float var = __fsub_rn(1.0f, expf(__fmul_rn(log_mean_coeff, 2.0f)));
    return __fmul_rn(__fsqrt_rn(var), g);
  }
  return __fmul_rn(__fmul_rn(powf(b, t), a), g);
}

__global__ void score_pre(long long* clock, long long* mode, long long* sem, long long* modes,
                          const float* drift_rate, const float* err_acc, const float* tau_0,
                          const float* overrun, int auto_calibrate, long long R) {
  const long long since = clock[kStep] - clock[kLastFull];
  const long long cold = clock[kCold];
  const float tau = auto_calibrate ? __fdiv_rn(*tau_0, clamp_min1(*overrun)) : *tau_0;
  const bool calibration = *drift_rate == 0.0f && since == 1;
  const long long compute =
      (*err_acc >= tau || calibration || since >= R || cold != 0) ? 1 : 0;
  const long long branch = compute * (1 + cold);
  *sem = compute;
  *mode = branch;
  modes[clock[kI]] = compute;
  clock[kRuns + branch] += 1;
}

__global__ void score_skip(const long long* clock, const float* ts, const float* G,
                           const float* eps_hat, const float* eps_prev, const float* eps_prev2,
                           const float* eps_gap, const float* eps_gap2, const float* drift_rate,
                           float* err_acc, float* score, int order, int kind, float a, float b,
                           int n, int seq, int channels) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx == 0) *err_acc = __fadd_rn(*err_acc, *drift_rate);
  if (idx >= n) return;
  const float std = marginal_std(kind, a, b, ts[clock[kI]], G[(idx / channels) % seq]);
  const float ahead = (float)(clock[kStep] - clock[kLastFull] + 1);
  const float hat = eps_hat[idx];
  float pred = hat;
  if (order >= 1) {
    const float gap = *eps_gap;
    const float prev = eps_prev[idx];
    const float slope1 = gap > 0.0f ? __fdiv_rn(__fsub_rn(hat, prev), clamp_min1(gap)) : 0.0f;
    pred = __fadd_rn(hat, __fmul_rn(slope1, ahead));
    if (order >= 2) {
      const float gap2 = *eps_gap2;
      const float slope2 =
          gap2 > 0.0f ? __fdiv_rn(__fsub_rn(prev, eps_prev2[idx]), clamp_min1(gap2)) : 0.0f;
      const float span = __fmul_rn(clamp_min1(__fadd_rn(gap, gap2)), 0.5f);
      const float curvature =
          gap > 0.0f && gap2 > 0.0f ? __fdiv_rn(__fsub_rn(slope1, slope2), span) : 0.0f;
      const float term =
          __fmul_rn(__fmul_rn(__fmul_rn(curvature, 0.5f), ahead), __fadd_rn(ahead, gap));
      pred = __fadd_rn(pred, term);
    }
  }
  score[idx] = __fdiv_rn(-pred, std);
}

// VP: a = beta_min, b = beta_max - beta_min (x <- x - (-0.5 beta x - d^2 s) dt + sqrt(dt) d z,
// d = sqrt(beta) g, beta = beta_min + t b); VE: a = sigma_min sqrt(2 log ratio), b = ratio
// (x <- x - (-d^2 s) dt + sqrt(dt) d z, d = a ratio^t g).
__global__ void score_post(long long* clock, const long long* sem, const float* ts,
                           const float* step_size, const float* G, const float* score,
                           const float* noise, long long noise_step, float* x,
                           unsigned int* done, int kind, float a, float b, int n, int seq,
                           int channels, long long max_len) {
  const long long i = clock[kI];
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) {
    const float t = ts[i];
    const float dt = *step_size;
    const float g = G[(idx / channels) % seq];
    const float xv = x[idx];
    const float s = score[idx];
    float drift, diffusion;
    if (kind == kVP) {
      const float beta = __fadd_rn(__fmul_rn(t, b), a);
      diffusion = __fmul_rn(__fsqrt_rn(beta), g);
      drift = __fsub_rn(__fmul_rn(__fmul_rn(beta, -0.5f), xv),
                        __fmul_rn(__fmul_rn(diffusion, diffusion), s));
    } else {
      diffusion = __fmul_rn(__fmul_rn(powf(b, t), a), g);
      drift = __fmul_rn(-__fmul_rn(diffusion, diffusion), s);
    }
    const float moved = __fsub_rn(xv, __fmul_rn(drift, dt));
    const float kick = __fmul_rn(__fmul_rn(__fsqrt_rn(dt), diffusion), noise[i * noise_step + idx]);
    x[idx] = __fadd_rn(moved, kick);
  }
  __shared__ bool last;
  __syncthreads();  // every thread of the block has read i
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  // count_mode at the score level: the step's mode is 1 (refresh) or 0 (skip).
  const long long m = *sem;
  const long long full = m == 1, mixed = m == 2, cached = m == 0;
  const long long step = clock[kStep], last_full = clock[kLastFull];
  const long long recomputed = full * max_len;
  clock[kLastFull] = last_full + full * (step - last_full);
  clock[kCold] = clock[kCold] * (full == 0);
  clock[kRecompute] += recomputed;
  clock[kHits] += max_len - recomputed;
  clock[kFull] += full;
  clock[kMixed] += mixed;
  clock[kCached] += cached;
  clock[kStep] = step + 1;
  clock[kI] = i + 1;
  *done = 0;
}

int blocks(int n) { return n > 0 ? (n + kThreads - 1) / kThreads : 1; }

}  // namespace

extern "C" int fdtpu_chain_score_pre(void* clock, void* mode, void* sem, void* modes,
                                     const void* drift_rate, const void* err_acc,
                                     const void* tau_0, const void* overrun, int auto_calibrate,
                                     long long R, void* stream) {
  score_pre<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(clock), static_cast<long long*>(mode),
      static_cast<long long*>(sem), static_cast<long long*>(modes),
      static_cast<const float*>(drift_rate), static_cast<const float*>(err_acc),
      static_cast<const float*>(tau_0), static_cast<const float*>(overrun), auto_calibrate, R);
  return (int)cudaGetLastError();
}

extern "C" int fdtpu_chain_score_skip(const void* clock, const void* ts, const void* G,
                                      const void* eps_hat, const void* eps_prev,
                                      const void* eps_prev2, const void* eps_gap,
                                      const void* eps_gap2, const void* drift_rate,
                                      void* err_acc, void* score, int order, int kind, float a,
                                      float b, int n, int seq, int channels, void* stream) {
  score_skip<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(clock), static_cast<const float*>(ts),
      static_cast<const float*>(G), static_cast<const float*>(eps_hat),
      static_cast<const float*>(eps_prev), static_cast<const float*>(eps_prev2),
      static_cast<const float*>(eps_gap), static_cast<const float*>(eps_gap2),
      static_cast<const float*>(drift_rate), static_cast<float*>(err_acc),
      static_cast<float*>(score), order, kind, a, b, n, seq, channels);
  return (int)cudaGetLastError();
}

extern "C" int fdtpu_chain_score_post(void* clock, const void* sem, const void* ts,
                                      const void* step_size, const void* G, const void* score,
                                      const void* noise, long long noise_step, void* x,
                                      void* done, int kind, float a, float b, int n, int seq,
                                      int channels, long long max_len, void* stream) {
  score_post<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(clock), static_cast<const long long*>(sem),
      static_cast<const float*>(ts), static_cast<const float*>(step_size),
      static_cast<const float*>(G), static_cast<const float*>(score),
      static_cast<const float*>(noise), noise_step, static_cast<float*>(x),
      static_cast<unsigned int*>(done), kind, a, b, n, seq, channels, max_len);
  return (int)cudaGetLastError();
}
