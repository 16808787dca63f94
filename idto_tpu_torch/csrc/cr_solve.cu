// Block cyclic-reduction solve of block-tridiagonal SPD systems, one
// thread block per system, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel idto_tpu/ops/cr_pallas.py:_cr_kernel (launched by
// solve_tridiag_many's pl.pallas_call).  It computes exactly what that
// kernel computes, in the same order: per level, pivot-free Gauss-Jordan
// inverses of the even diagonal blocks, multipliers
// alpha = L_odd Cinv_even and beta = U_odd Cinv_below, reduction of the odd
// rows' L, C, U and right-hand sides; then the final one-block solve and
// level-by-level back substitution of the even rows.  The Mosaic
// workarounds of the TPU kernel (one-hot reductions, identity from iota,
// the half == 1 special case) are not carried over.
//
// Inputs (row-major, contiguous): L, C, U (batch, mpow, K, K); b (batch, R,
// mpow, K).  Output x (batch, R, mpow, K).  mpow is a power of two.
//
// What bounds it on this card, and what the design does about it:
//  * At batch 1 the whole solve is one block walking a dependent chain:
//    log2(mpow) levels, each a sequence of K-step Gauss-Jordan inversions
//    (two block barriers per pivot) and 38x38 block products.  It is
//    latency bound on one SM; the design keeps every operand of the
//    current block product in shared memory so each barrier-separated
//    step is a short shared-memory pass, and it launches once per solve.
//  * At large batch every SM holds blocks, and the bound becomes the
//    traffic of the working bands: in float64 the level-0 bands of one
//    system are 3 * 16 * 38^2 * 8 B = 541 KiB, more than the 227 KB of
//    shared memory a block can have.  So the reduced bands, the saved
//    inverses and the reduced right-hand sides live in a global scratch
//    allocated by the caller (about 2x the input bands per system), and
//    only four K x K blocks are staged in shared memory at a time.  That
//    scratch is read and written once per level and mostly stays in the
//    50 MB L2 at moderate batch.  wgmma, TMA, clusters and a Cholesky
//    variant are left for later work.
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

// Scratch layout per system, in elements (see work_elems below):
//   Lw, Cw, Uw : (mpow - 1) blocks each, levels 1.. of the reduction;
//                level l (size s = mpow >> l) starts at block mpow - 2 s.
//   Cinv       : (mpow - 1) blocks; the inverses made at level l (s/2 of
//                them) start at block mpow - s.
//   bw         : R x (mpow - 1) x K, right-hand sides of levels 1..
//   rt         : R x (mpow / 2) x K, back-substitution residuals.
__host__ __device__ inline size_t work_elems(int mpow, int K, int R) {
  size_t kk = (size_t)K * K;
  size_t lv = (size_t)(mpow - 1);
  return 4 * lv * kk + (size_t)R * lv * K + (size_t)R * (mpow / 2) * K + 1;
}

template <typename T>
struct Level {
  const T* L;
  const T* C;
  const T* U;
  const T* b;
  size_t bstride;  // elements between right-hand sides r and r + 1
};

template <typename T>
__device__ void load_block(T* dst, const T* src, int KK) {
  for (int e = threadIdx.x; e < KK; e += blockDim.x) dst[e] = src[e];
}

template <typename T>
__device__ void store_block(T* dst, const T* src, int KK) {
  for (int e = threadIdx.x; e < KK; e += blockDim.x) dst[e] = src[e];
}

// In-place pivot-free Gauss-Jordan inverse of the K x K block M (shared).
// The blocks inverted are SPD Schur complements, so pivots stay positive.
template <typename T>
__device__ void gj_inverse(T* M, T* fcol, T* rrow, int K) {
  const int KK = K * K;
  for (int j = 0; j < K; ++j) {
    for (int t = threadIdx.x; t < K; t += blockDim.x) {
      fcol[t] = M[t * K + j];
      rrow[t] = M[j * K + t];
    }
    __syncthreads();
    const T recip = T(1) / fcol[j];
    for (int e = threadIdx.x; e < KK; e += blockDim.x) {
      const int i = e / K;
      const int c = e - i * K;
      if (i == j) {
        M[e] = (c == j) ? recip : rrow[c] * recip;
      } else if (c == j) {
        M[e] = -fcol[i] * recip;
      } else {
        M[e] = M[e] - fcol[i] * (rrow[c] * recip);
      }
    }
    __syncthreads();
  }
}

// sum_k A[i, k] B[k, c] for shared K x K operands.
template <typename T>
__device__ inline T dot_ik_kc(const T* A, const T* B, int i, int c, int K) {
  T s = T(0);
  for (int k = 0; k < K; ++k) s += A[i * K + k] * B[k * K + c];
  return s;
}

// sum_k A[i, k] v[k].
template <typename T>
__device__ inline T dot_row(const T* A, const T* v, int i, int K) {
  T s = T(0);
  for (int k = 0; k < K; ++k) s += A[i * K + k] * v[k];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cr_solve_kernel(const T* __restrict__ L0, const T* __restrict__ C0,
                const T* __restrict__ U0, const T* __restrict__ b0,
                T* __restrict__ x, T* __restrict__ work, int mpow, int K,
                int R) {
  extern __shared__ unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);  // alpha
  T* sB = sA + K * K;                      // beta
  T* sX = sB + K * K;                      // operand / Gauss-Jordan block
  T* sY = sX + K * K;                      // operand
  T* fcol = sY + K * K;
  T* rrow = fcol + K;

  const int KK = K * K;
  const size_t sys = blockIdx.x;
  const size_t band = (size_t)mpow * KK;
  const size_t lv = (size_t)(mpow - 1);

  T* wsys = work + sys * work_elems(mpow, K, R);
  T* Lw = wsys;
  T* Cw = Lw + lv * KK;
  T* Uw = Cw + lv * KK;
  T* Cinv = Uw + lv * KK;
  T* bw = Cinv + lv * KK;
  T* rt = bw + (size_t)R * lv * K;
  T* xs = x + sys * (size_t)R * mpow * K;
  const size_t xstride = (size_t)mpow * K;

  auto level = [&](int s) -> Level<T> {
    if (s == mpow) {
      return Level<T>{L0 + sys * band, C0 + sys * band, U0 + sys * band,
                      b0 + sys * (size_t)R * mpow * K, (size_t)mpow * K};
    }
    const size_t off = (size_t)(mpow - 2 * s);
    return Level<T>{Lw + off * KK, Cw + off * KK, Uw + off * KK,
                    bw + off * K, lv * K};
  };

  // ---- downward: reduce matrix and right-hand sides together ----
  for (int s = mpow; s > 1; s /= 2) {
    const int h = s / 2;
    const Level<T> cur = level(s);
    T* nL = Lw + (size_t)(mpow - 2 * h) * KK;
    T* nC = Cw + (size_t)(mpow - 2 * h) * KK;
    T* nU = Uw + (size_t)(mpow - 2 * h) * KK;
    T* nb = bw + (size_t)(mpow - 2 * h) * K;
    T* inv = Cinv + (size_t)(mpow - s) * KK;

    for (int j = 0; j < h; ++j) {  // inverses of the even diagonal blocks
      load_block(sX, cur.C + (size_t)(2 * j) * KK, KK);
      __syncthreads();
      gj_inverse(sX, fcol, rrow, K);
      store_block(inv + (size_t)j * KK, sX, KK);
      __syncthreads();
    }

    for (int j = 0; j < h; ++j) {
      const bool below = j + 1 < h;  // else identity / zero padding
      // alpha = L_odd Cinv_even
      load_block(sY, cur.L + (size_t)(2 * j + 1) * KK, KK);
      load_block(sX, inv + (size_t)j * KK, KK);
      __syncthreads();
      for (int e = threadIdx.x; e < KK; e += blockDim.x)
        sA[e] = dot_ik_kc(sY, sX, e / K, e % K, K);
      __syncthreads();
      // beta = U_odd Cinv_below (= U_odd when below is the identity pad)
      load_block(sY, cur.U + (size_t)(2 * j + 1) * KK, KK);
      if (below) load_block(sX, inv + (size_t)(j + 1) * KK, KK);
      __syncthreads();
      for (int e = threadIdx.x; e < KK; e += blockDim.x)
        sB[e] = below ? dot_ik_kc(sY, sX, e / K, e % K, K) : sY[e];
      __syncthreads();
      // L' = -alpha L_even;  C' = C_odd - alpha U_even (- beta L_below)
      load_block(sX, cur.L + (size_t)(2 * j) * KK, KK);
      load_block(sY, cur.U + (size_t)(2 * j) * KK, KK);
      __syncthreads();
      const T* Codd = cur.C + (size_t)(2 * j + 1) * KK;
      for (int e = threadIdx.x; e < KK; e += blockDim.x) {
        const int i = e / K, c = e % K;
        nL[(size_t)j * KK + e] = -dot_ik_kc(sA, sX, i, c, K);
        nC[(size_t)j * KK + e] = Codd[e] - dot_ik_kc(sA, sY, i, c, K);
      }
      __syncthreads();
      // U' = -beta U_below
      if (below) {
        load_block(sX, cur.L + (size_t)(2 * j + 2) * KK, KK);
        load_block(sY, cur.U + (size_t)(2 * j + 2) * KK, KK);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < KK; e += blockDim.x) {
        const int i = e / K, c = e % K;
        if (below) {
          nC[(size_t)j * KK + e] =
              nC[(size_t)j * KK + e] - dot_ik_kc(sB, sX, i, c, K);
          nU[(size_t)j * KK + e] = -dot_ik_kc(sB, sY, i, c, K);
        } else {
          nU[(size_t)j * KK + e] = T(0);
        }
      }
      // b' = b_odd - alpha b_even - beta b_below
      for (int e = threadIdx.x; e < R * K; e += blockDim.x) {
        const int r = e / K, i = e % K;
        const T* br = cur.b + (size_t)r * cur.bstride;
        T acc = br[(size_t)(2 * j + 1) * K + i] -
                dot_row(sA, br + (size_t)(2 * j) * K, i, K);
        if (below) acc = acc - dot_row(sB, br + (size_t)(2 * j + 2) * K, i, K);
        nb[(size_t)r * lv * K + (size_t)j * K + i] = acc;
      }
      __syncthreads();
    }
  }

  // ---- the final single block: x = C^{-1} b ----
  {
    const Level<T> last = level(1);
    load_block(sX, last.C, KK);
    __syncthreads();
    gj_inverse(sX, fcol, rrow, K);
    for (int e = threadIdx.x; e < R * K; e += blockDim.x) {
      const int r = e / K, i = e % K;
      xs[(size_t)r * xstride + (size_t)(mpow - 1) * K + i] =
          dot_row(sX, last.b + (size_t)r * last.bstride, i, K);
    }
    __syncthreads();
  }

  // ---- upward: recover the eliminated even rows level by level ----
  // Row j of the level of size s = mpow >> l sits at original row
  // 2^l (j + 1) - 1, so x is written in place in the output.
  for (int s = 2; s <= mpow; s *= 2) {
    const int h = s / 2;
    const int step = mpow / s;  // 2^l
    const Level<T> cur = level(s);
    const T* inv = Cinv + (size_t)(mpow - s) * KK;
    for (int e = threadIdx.x; e < h * R * K; e += blockDim.x) {
      const int j = e / (R * K);
      const int r = (e / K) % R;
      const int i = e % K;
      const T* xr = xs + (size_t)r * xstride;
      const T* Lev = cur.L + (size_t)(2 * j) * KK;
      const T* Uev = cur.U + (size_t)(2 * j) * KK;
      const T* x_odd = xr + (size_t)(2 * step * (j + 1) - 1) * K;
      T sL = T(0);
      if (j > 0) sL = dot_row(Lev, xr + (size_t)(2 * step * j - 1) * K, i, K);
      const T sU = dot_row(Uev, x_odd, i, K);
      const T bev = cur.b[(size_t)r * cur.bstride + (size_t)(2 * j) * K + i];
      rt[((size_t)r * h + j) * K + i] = bev - sL - sU;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < h * R * K; e += blockDim.x) {
      const int j = e / (R * K);
      const int r = (e / K) % R;
      const int i = e % K;
      xs[(size_t)r * xstride + (size_t)(step * (2 * j + 1) - 1) * K + i] =
          dot_row(inv + (size_t)j * KK, rt + ((size_t)r * h + j) * K, i, K);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* L, const T* C, const T* U, const T* b, T* x, T* work,
           int batch, int mpow, int K, int R, void* stream) {
  const size_t smem = (4 * (size_t)K * K + 2 * (size_t)K) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cr_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cr_solve_kernel<T><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      L, C, U, b, x, work, mpow, K, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t cr_work_elems(int mpow, int K, int R) { return work_elems(mpow, K, R); }

int cr_solve_f64(const double* L, const double* C, const double* U,
                 const double* b, double* x, double* work, int batch, int mpow,
                 int K, int R, void* stream) {
  return launch<double>(L, C, U, b, x, work, batch, mpow, K, R, stream);
}

int cr_solve_f32(const float* L, const float* C, const float* U,
                 const float* b, float* x, float* work, int batch, int mpow,
                 int K, int R, void* stream) {
  return launch<float>(L, C, U, b, x, work, batch, mpow, K, R, stream);
}

}  // extern "C"
