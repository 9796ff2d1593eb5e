// Conditional nodes for the CUDA graphs that torch.cuda.graph captures.
//
// The reference takes every decision of a frame on the device with
// jax.lax.cond and runs its loops with jax.lax.while_loop
// (stereo_vo_tpu/engine/step.py, stereo_vo_tpu/backend/schur.py). The port
// captures its whole step as one CUDA graph and takes the same decisions
// with IF nodes and runs the same loops with WHILE nodes: a body runs when
// (an IF), or as long as (a WHILE), a 0-d bool on the device holds, with no
// read on the host. This PyTorch binds no conditional node in Python, so
// these calls add one to the graph that a stream is capturing
// (engine/graphs.py::cond, ::while_loop):
//
//   svo_cond_begin(stream, body_stream, pred, negate, type, handle_out,
//                  parent_out, node_out)
//     on the capturing `stream`: a one-thread kernel sets a conditional
//     handle from *pred (negated when `negate`), then a node of `type`
//     (0: IF, 1: WHILE) on that handle follows it, and the stream's later
//     work depends on the node; `body_stream` starts capturing into the
//     node's body graph; the handle is written to *handle_out. When
//     `stream` is `body_stream` itself (a node inside a body), its capture of
//     the enclosing body is suspended first: that graph and the new node are
//     written to *parent_out and *node_out (else both are 0);
//   svo_cond_set(stream, handle, pred)
//     on the capturing `stream`: the one-thread kernel that sets `handle`
//     from *pred; a WHILE body ends with it, so the node runs the body again
//     while the bool it computed holds;
//   svo_cond_end(body_stream, parent, node)
//     ends the body's capture (an empty body gets one empty node), then,
//     given a suspended `parent`, resumes capturing into it after `node`;
//   svo_cuda_versions(runtime, driver)
//     the CUDA runtime's and the driver's versions (a conditional node inside
//     a body graph needs 12.4 in both).
//
// Between begin and end the caller makes `body_stream` its current stream,
// so every operation of the body lands in the body graph. Bodies nest on one
// body stream: a nested body suspends the capture of the body around it and
// resumes it when it ends, since a stream captures into one graph at a time.
// One stream for every body matters to libraries that keep state per stream:
// cuSOLVER's solves take cuBLAS scratch, which, once it has been taken under
// capture on one stream, is freed and taken again (memory-free and
// memory-allocation nodes, which a conditional body cannot hold) when a
// capture moves the solves to another stream.
// The handle is reset to false at every launch of its graph
// (cudaGraphCondAssignDefault), so a body runs only when this launch's kernel
// set it. Every call returns the first CUDA error (0 on success) and none
// synchronises.

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

cudaError_t set_condition(cudaStream_t stream, cudaGraphConditionalHandle handle,
                          const bool* pred, int negate) {
    set_condition_kernel<<<1, 1, 0, stream>>>(handle, pred, negate);
    return cudaGetLastError();
}

}  // namespace

extern "C" int svo_cond_begin(void* stream_ptr, void* body_ptr, const bool* pred, int negate,
                              int type, unsigned long long* handle_out, void** parent_out,
                              void** node_out) {
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
    err = set_condition(stream, handle, pred, negate);
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
    params.conditional.type = type == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
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
    *handle_out = static_cast<unsigned long long>(handle);
    *parent_out = nullptr;
    *node_out = nullptr;
    if (stream == body) {
        cudaGraph_t parent;
        err = cudaStreamEndCapture(body, &parent);
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
        *parent_out = parent;
        *node_out = node;
    }
    err = cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr,
                                        nullptr, 0, cudaStreamCaptureModeThreadLocal);
    return static_cast<int>(err);
}

extern "C" int svo_cond_set(void* stream_ptr, unsigned long long handle, const bool* pred) {
    return static_cast<int>(set_condition(static_cast<cudaStream_t>(stream_ptr),
                                          static_cast<cudaGraphConditionalHandle>(handle),
                                          pred, 0));
}

extern "C" int svo_cond_end(void* body_ptr, void* parent, void* node) {
    cudaStream_t body = static_cast<cudaStream_t>(body_ptr);
    cudaGraph_t graph;
    cudaError_t err = cudaStreamEndCapture(body, &graph);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    size_t n = 0;
    err = cudaGraphGetNodes(graph, nullptr, &n);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    if (n == 0) {
        cudaGraphNode_t empty;
        err = cudaGraphAddEmptyNode(&empty, graph, nullptr, 0);
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
    }
    if (parent == nullptr) {
        return 0;
    }
    cudaGraphNode_t after = static_cast<cudaGraphNode_t>(node);
    err = cudaStreamBeginCaptureToGraph(body, static_cast<cudaGraph_t>(parent), &after, nullptr,
                                        1, cudaStreamCaptureModeThreadLocal);
    return static_cast<int>(err);
}

extern "C" int svo_cuda_versions(int* runtime, int* driver) {
    cudaError_t err = cudaRuntimeGetVersion(runtime);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    return static_cast<int>(cudaDriverGetVersion(driver));
}
