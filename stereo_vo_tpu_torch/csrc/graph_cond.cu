// Conditional nodes for the CUDA graphs that torch.cuda.graph captures.
//
// The reference takes every decision of a frame on the device with
// jax.lax.cond (stereo_vo_tpu/engine/step.py, stereo_vo_tpu/frontend/track.py).
// The port captures its whole step as one CUDA graph and takes the same
// decisions with IF nodes: a body runs when a 0-d bool on the device is true
// (or false, for the else side), with no read on the host. This PyTorch binds
// no conditional node in Python, so these two calls add one to the graph that
// a stream is capturing (engine/graphs.py::cond):
//
//   svo_cond_begin(stream, body_stream, pred, negate)
//     on the capturing `stream`: a one-thread kernel sets a conditional
//     handle from *pred (negated when `negate`), then an IF node on that
//     handle follows it, and the stream's later work depends on the node;
//     `body_stream` starts capturing into the node's body graph;
//   svo_cond_end(body_stream)
//     ends the body's capture (an empty body gets one empty node).
//
// Between the two calls the caller makes `body_stream` its current stream,
// so every operation of the body lands in the body graph. Bodies do not nest.
// The handle is reset to false at every launch of the graph
// (cudaGraphCondAssignDefault), so a body runs only when this launch's kernel
// set it. Both calls return the first CUDA error (0 on success) and do not
// synchronise.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred,
                                     int negate) {
    const bool take = (*pred) != (negate != 0);
    cudaGraphSetConditional(handle, take ? 1u : 0u);
}

// the graph `stream` captures into, and the nodes its next work depends on
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
    cudaStreamCaptureStatus status;
    unsigned long long id = 0;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, nullptr, ndeps);
#else
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, ndeps);
#endif
    if (err != cudaSuccess) {
        return err;
    }
    return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" int svo_cond_begin(void* stream_ptr, void* body_ptr, const bool* pred, int negate) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaStream_t body = static_cast<cudaStream_t>(body_ptr);
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t ndeps = 0;
    cudaError_t err = capture_info(stream, &graph, &deps, &ndeps);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    set_condition_kernel<<<1, 1, 0, stream>>>(handle, pred, negate);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    // the dependencies now end at the kernel just captured
    err = capture_info(stream, &graph, &deps, &ndeps);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
    err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
#if CUDART_VERSION >= 13000
    err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                              cudaStreamSetCaptureDependencies);
#else
    err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    err = cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr,
                                        nullptr, 0, cudaStreamCaptureModeThreadLocal);
    return static_cast<int>(err);
}

extern "C" int svo_cond_end(void* body_ptr) {
    cudaStream_t body = static_cast<cudaStream_t>(body_ptr);
    cudaGraph_t graph;
    cudaError_t err = cudaStreamEndCapture(body, &graph);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    size_t n = 0;
    err = cudaGraphGetNodes(graph, nullptr, &n);
    if (err != cudaSuccess || n > 0) {
        return static_cast<int>(err);
    }
    cudaGraphNode_t empty;
    return static_cast<int>(cudaGraphAddEmptyNode(&empty, graph, nullptr, 0));
}
