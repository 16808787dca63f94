// Host stand-in for the CUDA pieces that idto_tpu_torch/csrc/cr_solve.cu
// uses, so that its device code compiles with a C++20 host compiler and
// runs with one host thread for each CUDA thread of a block:
// tests/test_torch_cr_source.py.  Barriers are real barriers, so a missing
// __syncwarp() or team barrier can still show as a wrong result; copies
// that are asynchronous on the card complete at once here.
#include <barrier>
#include <cstddef>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __noinline__
#define __shared__
#define __align__(x)
#define __launch_bounds__(...)

struct alignas(16) double2 {
  double x, y;
};
struct alignas(8) float2 {
  float x, y;
};
struct Dim3 {
  int x, y, z;
};

namespace {

struct WarpState {
  std::barrier<> bar{32};
  double a[32][4], b[32][2];  // operands of the warp-wide mma
};

thread_local Dim3 threadIdx, blockIdx, blockDim;
thread_local WarpState* this_warp;
std::barrier<>* named_barriers[16];
alignas(16) unsigned char smem_raw[232448];

inline void __syncwarp() { this_warp->bar.arrive_and_wait(); }

inline void named_barrier(int id, int) {
  named_barriers[id]->arrive_and_wait();
}

template <int BYTES>
inline void cp_async(void* smem, const void* gmem) {
  std::memcpy(smem, gmem, BYTES);
}

inline void cp_async_wait_all() {}

// mma.m16n8k8 on float64 with the fragment layout the kernel states.
inline void dmma_m16n8k8(double& c0, double& c1, double& c2, double& c3,
                         double a0, double a1, double a2, double a3,
                         double b0, double b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double* a = this_warp->a[lane];
  a[0] = a0, a[1] = a1, a[2] = a2, a[3] = a3;
  this_warp->b[lane][0] = b0, this_warp->b[lane][1] = b1;
  __syncwarp();
  for (int k = 0; k < 8; ++k) {
    const double* ak = this_warp->a[g * 4 + (k & 3)] + (k >> 2) * 2;
    const double bl = this_warp->b[(2 * t) * 4 + (k & 3)][k >> 2];
    const double bh = this_warp->b[(2 * t + 1) * 4 + (k & 3)][k >> 2];
    c0 += ak[0] * bl, c1 += ak[0] * bh, c2 += ak[1] * bl, c3 += ak[1] * bh;
  }
  __syncwarp();
}

}  // namespace
