// The gather probe's instruments (tools/gather_probe.py), not kernels of a
// path: an empty kernel and one warp's index -> source chain, the latency
// floor of any gather on the card; and an L2 flush that only reads.

#include <cuda_runtime.h>
#include <stdint.h>

// global names: the flush is left out of a trace by its name's prefix
__global__ void empty_kernel() {}

__global__ void chain_kernel(const int32_t* __restrict__ idx, const float* __restrict__ src,
                             float* __restrict__ out) {
  out[threadIdx.x] = src[idx[threadIdx.x]];
}

// reads n float4 through L2 and stores nothing (the sum of a zero buffer is
// never the sentinel): an L2 flush that leaves no dirty line behind
__global__ void clean_flush_kernel(const float4* __restrict__ buf, long long n,
                                   float* __restrict__ sink) {
  float acc = 0.f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = __ldcg(buf + i);
    acc += v.x + v.y + v.z + v.w;
  }
  if (acc == 1234.5f) sink[0] = acc;
}

extern "C" {

int empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// out[t] = src[idx[t]] for the 32 threads of one warp
int chain(const int32_t* idx, const float* src, float* out, void* stream) {
  chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(idx, src, out);
  return static_cast<int>(cudaGetLastError());
}

// reads n float4 of buf; sink (one float) is never written in practice
int clean_flush(const void* buf, long long n, float* sink, void* stream) {
  clean_flush_kernel<<<1056, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(buf), n, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
