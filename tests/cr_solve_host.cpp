// Runs the device code of idto_tpu_torch/csrc/cr_solve.cu on host threads:
// one block at a time, one thread for each CUDA thread, under
// cr_solve_host_shim.h.  Built and driven by tests/test_torch_cr_source.py.
#define CR_SOLVE_HOST_SHIM "cr_solve_host_shim.h"
#include "cr_solve.cu"

#include <memory>
#include <thread>
#include <vector>

namespace {

template <typename T, typename E>
void run(const T* L, const T* C, const T* U, const T* b, T* x, T* work,
         int batch, int m, int rows, int K, int R, int warps, int team,
         int vcap) {
  const int per_block = warps / team;
  const int blocks = (batch + per_block - 1) / per_block;
  for (int blk = 0; blk < blocks; ++blk) {
    std::vector<std::unique_ptr<std::barrier<>>> teams;
    for (int i = 0; i < 16; ++i) {
      teams.emplace_back(new std::barrier<>(32 * team));
      named_barriers[i] = teams.back().get();
    }
    std::vector<std::unique_ptr<WarpState>> ws;
    for (int w = 0; w < warps; ++w) ws.emplace_back(new WarpState());
    std::memset(smem_raw, 0xff, sizeof(smem_raw));  // NaNs until written
    std::vector<std::thread> threads;
    for (int tid = 0; tid < warps * 32; ++tid)
      threads.emplace_back([&, tid] {
        threadIdx = {tid, 0, 0};
        blockIdx = {blk, 0, 0};
        blockDim = {warps * 32, 1, 1};
        this_warp = ws[tid / 32].get();
        cr_solve_kernel<T, E>(L, C, U, b, x, work, batch, m, rows, K, R, team,
                              vcap);
      });
    for (auto& th : threads) th.join();
  }
}

template <typename T, typename E>
int run_checked(const T* L, const T* C, const T* U, const T* b, T* x, T* work,
                int batch, int m, int rows, int K, int R, int warps,
                int team, int vecs) {
  // Room for `vecs` right-hand sides at a time in the back substitution
  // (0: the least a warp may have, one at a time).
  const int vmin = min_vec_elems(E::ld(K));
  const int vcap = 3 * vecs * K > vmin ? (3 * vecs * K + 3) & ~3 : vmin;
  const size_t bytes = (size_t)warps * sizeof(T) *
                       (3 * E::buf_elems(K) + E::ex_elems(K) + vcap);
  if (bytes > sizeof(smem_raw)) return 1;
  run<T, E>(L, C, U, b, x, work, batch, m, rows, K, R, warps, team, vcap);
  return 0;
}

template <typename T>
int dispatch(const T* L, const T* C, const T* U, const T* b, T* x, T* work,
             int batch, int m, int rows, int K, int R, int warps, int team,
             int vecs) {
  if (K == 2)
    return run_checked<T, TileEngine<T, 2>>(L, C, U, b, x, work, batch, m,
                                            rows, K, R, warps, team, vecs);
  if (K == 6)
    return run_checked<T, TileEngine<T, 6>>(L, C, U, b, x, work, batch, m,
                                            rows, K, R, warps, team, vecs);
  if (K == 38)
    return run_checked<T, TileEngine<T, 38>>(L, C, U, b, x, work, batch, m,
                                             rows, K, R, warps, team, vecs);
  return run_checked<T, PlainEngine<T>>(L, C, U, b, x, work, batch, m, rows,
                                        K, R, warps, team, vecs);
}

}  // namespace

extern "C" {

size_t host_work_elems(int rows, int K, int R) {
  return work_elems(rows, K, R);
}

int host_solve_f64(const double* L, const double* C, const double* U,
                   const double* b, double* x, double* work, int batch, int m,
                   int rows, int K, int R, int warps, int team, int vecs) {
  return dispatch<double>(L, C, U, b, x, work, batch, m, rows, K, R, warps,
                          team, vecs);
}

int host_solve_f32(const float* L, const float* C, const float* U,
                   const float* b, float* x, float* work, int batch, int m,
                   int rows, int K, int R, int warps, int team, int vecs) {
  return dispatch<float>(L, C, U, b, x, work, batch, m, rows, K, R, warps,
                         team, vecs);
}

}  // extern "C"
