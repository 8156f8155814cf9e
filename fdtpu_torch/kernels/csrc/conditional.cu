// Conditional nodes of CUDA graphs (WHILE and IF), for Hopper (sm_90a): the device side of the
// resident reverse chain (fdtpu_torch/utils/conditional.py, fdtpu_torch/sampling/resident.py).
//
// Replaces no TPU kernel.  It is the port's counterpart of the control flow that the JAX
// package compiles into one XLA program: `lax.scan` over the steps of a trajectory and, inside
// its body, `lax.cond` (score level) and `lax.switch` (token level) on the E2-CRF decision
// (fdtpu/sampling/sampler.py, `score_level_body`, `token_level_body`, `kv_level_body`).  A
// CUDA graph takes that form with conditional nodes (CUDA 12.4 and later): a WHILE node runs
// its body graph while its handle is nonzero; an IF node runs its body graph once when its
// handle is nonzero.  A handle is set on the device, by a kernel in the graph that calls
// cudaGraphSetConditional, so the decision never reaches the host.
//
// Two kernels, one thread each: `set_branch_handles` sets the IF handle of branch k to
// (*mode == k) for the k branches of a step; `set_while_handle` sets the WHILE handle to
// (*clock < limit) after a step.  What bounds them is the launch of a graph node (a few
// microseconds), not bytes or operations: each reads one int64.
//
// The host functions build the graph with the runtime API.  `fdtpu_cond_begin_while` appends a
// WHILE node to the graph that a stream is capturing (cudaStreamGetCaptureInfo_v3, then
// cudaGraphAddNode after the capture's current dependencies, then
// cudaStreamUpdateCaptureDependencies), so the capture goes on after the loop; the others add
// nodes to a body graph: a child graph (a segment captured by PyTorch), an IF node, a setter
// kernel.  `fdtpu_cond_count_kernels` counts a graph's kernel nodes once, at capture, so the
// host can count the kernels of a replay, which tells it nothing.  Every function returns its
// cudaError_t; 0 is success.

#include <cuda_runtime.h>

#include <cstring>
#include <vector>

namespace {

constexpr int kMaxBranches = 8;

struct Branches {
  cudaGraphConditionalHandle handle[kMaxBranches];
};

__global__ void set_branch_handles(const long long* mode, Branches branches, int n) {
  const long long m = *mode;
  for (int k = 0; k < n; ++k) cudaGraphSetConditional(branches.handle[k], m == k ? 1u : 0u);
}

__global__ void set_while_handle(const long long* clock, long long limit,
                                 cudaGraphConditionalHandle handle) {
  cudaGraphSetConditional(handle, *clock < limit ? 1u : 0u);
}

cudaError_t add_conditional(cudaGraph_t graph, const cudaGraphNode_t* deps, size_t n_deps,
                            cudaGraphConditionalHandle handle,
                            cudaGraphConditionalNodeType type, cudaGraphNode_t* node,
                            cudaGraph_t* body) {
  // Aggregate initialisation: the type's default constructor is deleted.
  cudaGraphNodeParams params = {cudaGraphNodeTypeConditional};
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  const cudaError_t err = cudaGraphAddNode(node, graph, deps, n_deps, &params);
  if (err == cudaSuccess) *body = params.conditional.phGraph_out[0];
  return err;
}

cudaError_t add_kernel(cudaGraph_t graph, cudaGraphNode_t dep, void* func, void** args,
                       cudaGraphNode_t* node) {
  cudaKernelNodeParams params;
  std::memset(&params, 0, sizeof(params));
  params.func = func;
  params.gridDim = dim3(1, 1, 1);
  params.blockDim = dim3(1, 1, 1);
  params.sharedMemBytes = 0;
  params.kernelParams = args;
  params.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep ? &dep : nullptr, dep ? 1 : 0, &params);
}

// Adds the kernel nodes of `graph` and of its child graphs to `*kernels`.
cudaError_t count_kernels(cudaGraph_t graph, unsigned long long* kernels) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (err != cudaSuccess) return err;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return err;
    if (type == cudaGraphNodeTypeKernel) {
      ++*kernels;
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = count_kernels(child, kernels);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// Appends a WHILE node to the graph `stream` is capturing, after its current dependencies,
// and makes the node the capture's only dependency.  The handle starts at 1 at every launch
// of the graph (cudaGraphCondAssignDefault), so the body runs at least once.
extern "C" int fdtpu_cond_begin_while(void* stream, int device, unsigned long long* handle_out,
                                      void** body_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  const cudaGraphEdgeData* edges = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo_v3(s, &status, &id, &graph, &deps, &edges, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 1u, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t node;
  cudaGraph_t body;
  err = add_conditional(graph, deps, n_deps, handle, cudaGraphCondTypeWhile, &node, &body);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  *handle_out = handle;
  *body_out = body;
  return 0;
}

// Creates a handle for a conditional node of `graph`: 0 until a setter kernel sets it.
extern "C" int fdtpu_cond_handle(void* graph, unsigned long long* handle_out) {
  cudaGraphConditionalHandle handle;
  const cudaError_t err =
      cudaGraphConditionalHandleCreate(&handle, static_cast<cudaGraph_t>(graph), 0u, 0u);
  if (err == cudaSuccess) *handle_out = handle;
  return (int)err;
}

// Adds an IF node on `handle` to `graph` after `dep` (null: no dependency).
extern "C" int fdtpu_cond_add_if(void* graph, void* dep, unsigned long long handle,
                                 void** node_out, void** body_out) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t node;
  cudaGraph_t body;
  const cudaError_t err = add_conditional(static_cast<cudaGraph_t>(graph), d ? &d : nullptr,
                                          d ? 1 : 0, handle, cudaGraphCondTypeIf, &node, &body);
  if (err != cudaSuccess) return (int)err;
  *node_out = node;
  *body_out = body;
  return 0;
}

// Adds a child-graph node running a copy of `child` to `graph` after `dep`.
extern "C" int fdtpu_cond_add_child(void* graph, void* dep, void* child, void** node_out) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t node;
  const cudaError_t err = cudaGraphAddChildGraphNode(
      &node, static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0,
      static_cast<cudaGraph_t>(child));
  if (err == cudaSuccess) *node_out = node;
  return (int)err;
}

// Adds the kernel node that sets handles[k] to (*mode == k), k < n, after `dep`.
extern "C" int fdtpu_cond_add_branch_setter(void* graph, void* dep, const void* mode,
                                            const unsigned long long* handles, int n,
                                            void** node_out) {
  if (n < 1 || n > kMaxBranches) return (int)cudaErrorInvalidValue;
  Branches branches;
  std::memset(&branches, 0, sizeof(branches));
  for (int k = 0; k < n; ++k) branches.handle[k] = handles[k];
  const long long* m = static_cast<const long long*>(mode);
  void* args[] = {&m, &branches, &n};
  cudaGraphNode_t node;
  const cudaError_t err = add_kernel(static_cast<cudaGraph_t>(graph),
                                     static_cast<cudaGraphNode_t>(dep),
                                     reinterpret_cast<void*>(set_branch_handles), args, &node);
  if (err == cudaSuccess) *node_out = node;
  return (int)err;
}

// Adds the kernel node that sets `handle` to (*clock < limit) after `dep`.
extern "C" int fdtpu_cond_add_while_setter(void* graph, void* dep, const void* clock,
                                           long long limit, unsigned long long handle,
                                           void** node_out) {
  const long long* c = static_cast<const long long*>(clock);
  cudaGraphConditionalHandle h = handle;
  void* args[] = {&c, &limit, &h};
  cudaGraphNode_t node;
  const cudaError_t err = add_kernel(static_cast<cudaGraph_t>(graph),
                                     static_cast<cudaGraphNode_t>(dep),
                                     reinterpret_cast<void*>(set_while_handle), args, &node);
  if (err == cudaSuccess) *node_out = node;
  return (int)err;
}

// Counts the kernel nodes of `graph`, child graphs included; with `graph` null, of the graph
// `stream` is capturing, as captured so far.  A graph with conditional nodes is not counted: the
// runtime (CUDA 12.8 on the H100) answers cudaErrorUnknown when a WHILE body that holds IF nodes
// is walked, so the host counts a step from its segments and its setters.  The count is a
// diagnostic: a failure is returned and also cleared from the runtime's last error, so that no
// later launch check reports it.
extern "C" int fdtpu_cond_count_kernels(void* graph, void* stream, unsigned long long* out) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaSuccess;
  if (g == nullptr) {
    cudaStreamCaptureStatus status;
    unsigned long long id = 0;
    const cudaGraphNode_t* deps = nullptr;
    const cudaGraphEdgeData* edges = nullptr;
    size_t n_deps = 0;
    err = cudaStreamGetCaptureInfo_v3(static_cast<cudaStream_t>(stream), &status, &id, &g, &deps,
                                      &edges, &n_deps);
    if (err == cudaSuccess && status != cudaStreamCaptureStatusActive) {
      err = cudaErrorStreamCaptureImplicit;
    }
  }
  unsigned long long kernels = 0;
  if (err == cudaSuccess) err = count_kernels(g, &kernels);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  *out = kernels;
  return 0;
}

extern "C" const char* fdtpu_cond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
