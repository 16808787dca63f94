// Device stamps of the port's spans (idto_tpu_torch/utils/profiler.py).
//
// Replaces no TPU kernel: the JAX package's compiled step has no counterpart
// of it.  A span inside a captured region cannot read the host clock at
// replay, since a replay runs no host code; so at its entry and its exit
// the span enqueues ``span_stamp_kernel`` on the current stream, and inside
// a CUDA graph capture that launch becomes a node of the graph, which every
// replay runs again.  One thread takes the next slot of a ring of records
// with ``atomicAdd`` on a device counter and writes the span's code (site
// id << 1 | exit) and ``%globaltimer``, the device's nanosecond clock.  It
// is bound by launch latency alone: two 8-byte stores and one atomic.
//
// ``span_capture_nodes`` counts the kernel, memcpy and memset nodes of the
// graph that a stream is capturing into (child graphs included), so that
// the span can record how many the capture placed inside it.  It returns
// -1 when the stream is not capturing and -2 on an error of the runtime.
#include <cuda_runtime.h>

#include <vector>

__global__ void span_stamp_kernel(long long* ring, unsigned long long* count,
                                  unsigned long long mask, long long code) {
  unsigned long long slot = atomicAdd(count, 1ULL) & mask;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  ring[2 * slot] = code;
  ring[2 * slot + 1] = static_cast<long long>(now);
}

extern "C" int span_stamp(void* ring, void* count, unsigned long long mask,
                          long long code, void* stream) {
  span_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<unsigned long long*>(count),
      mask, code);
  return static_cast<int>(cudaGetLastError());
}

// Adds the graph's kernel, memcpy and memset nodes (child graphs included)
// to counts[0..2]; false on an error of the runtime.
static bool count_nodes(cudaGraph_t graph, long long* counts) {
  size_t n = 0;
  if (cudaGraphGetNodes(graph, nullptr, &n) != cudaSuccess) return false;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n && cudaGraphGetNodes(graph, nodes.data(), &n) != cudaSuccess)
    return false;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess) return false;
    if (type == cudaGraphNodeTypeKernel) {
      ++counts[0];
    } else if (type == cudaGraphNodeTypeMemcpy) {
      ++counts[1];
    } else if (type == cudaGraphNodeTypeMemset) {
      ++counts[2];
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      if (cudaGraphChildGraphNodeGetGraph(nodes[i], &child) != cudaSuccess ||
          !count_nodes(child, counts))
        return false;
    }
  }
  return true;
}

extern "C" int span_capture_nodes(void* stream, long long* counts) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  counts[0] = counts[1] = counts[2] = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               nullptr, &graph) != cudaSuccess)
    return -2;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) return -1;
  return count_nodes(graph, counts) ? 0 : -2;
}
