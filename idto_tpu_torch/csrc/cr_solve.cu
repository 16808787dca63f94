// Block cyclic-reduction solve of block-tridiagonal SPD systems for NVIDIA
// Hopper (sm_90a): one team of warps per system, one warp per block task.
//
// Replaces the TPU kernel idto_tpu/ops/cr_pallas.py:_cr_kernel (launched by
// solve_tridiag_many's pl.pallas_call).  It computes what that kernel
// computes: per level, pivot-free Gauss-Jordan inverses of the even
// diagonal blocks, multipliers alpha = L_odd Cinv_even and
// beta = U_odd Cinv_below, reduction of the odd rows' L, C, U and
// right-hand sides; then level-by-level back substitution of the even rows.
//
// Inputs (row-major, contiguous, 16-byte aligned): L, C, U (batch, m, K, K);
// b (batch, R, m, K).  Output x (batch, R, m, K).  Only the first `rows` of
// the m block rows are read, and of those neither L of row 0 nor U of row
// rows - 1, which multiply nothing; the rows past them count as identity rows
// (C = I, L = U = 0, b = 0) of a system padded to any power of two, and
// their x is written as zero.  Such rows reduce to identity rows at every
// level, so a level of `rows >> l` real rows is all that is ever touched
// and no power of two is needed: level l keeps the odd rows of level l - 1,
// and row j of level l is original row (j + 1) 2^l - 1.
//
// What bounds it on this card, and what the design does about it.
//  * Neither memory nor arithmetic binds one system: a mini-cheetah system
//    (rows = 11, K = 38, float64) reads 0.36 MB and does 5.8 MFLOP, a
//    fraction of a microsecond at the card's rates.  What binds is the chain
//    of dependent steps: floor(log2 rows) + 1 levels, each an inversion (K
//    dependent pivots) followed by six K x K products that depend on it.
//    At a batch of thousands the card's bound is the bytes (0.45 ms for
//    4096 cheetah systems), and the kernel is a few times above it, held by
//    the latency of the same chains run side by side.
//  * The blocks of a level are independent, so each is one warp's task: a
//    warp inverts a block, or reduces one odd row (its six products, its
//    right-hand sides and, when the reduced row is an even row of the next
//    level, that row's inverse as well), or back-substitutes one even row,
//    in its own three shared-memory buffers, synchronising with
//    __syncwarp() only.  The warps of a system meet once after the level-0
//    inverses, once after each level's reductions and once after each
//    level's back substitution: 2 floor(log2 rows) + 2 barriers, 8 for the
//    cheetah, where the first version of this kernel ran every inverse and
//    product on the whole block in turn behind about 1,300.  Along the
//    critical path a warp also passes about 16 + K __syncwarp() for each
//    level on the way down (K + 1 of them the pivots) and 3 on the way up,
//    some 220 for the cheetah.
//  * How many warps share a system follows the batch: all of a block's for
//    a batch below the card's SM count (the chain is then as short as it
//    gets), one warp a system once every warp of the card can have its own
//    (no warp then idles at the narrow levels, and the team's barrier is a
//    __syncwarp()), and in between what the card has to spare.  A team of
//    several warps meets on a named barrier (bar.sync id, threads).
//  * For the K of the registered examples (2, 6, 38) the block size is a
//    template parameter.  A warp then holds a whole K x K result in
//    registers as 8 x 8 tiles in the accumulator layout of mma.sync: the
//    float64 products run on the tensor cores (m16n8k8; the m8n8k4 shape
//    runs at a fraction of its rate on this card), the float32 ones are
//    full-precision FMAs on the same tiles, never TF32.  The inversion keeps
//    the block in the same registers and passes only the pivot row and
//    column through shared memory, one __syncwarp() a pivot; the tiles
//    rotate after every eight pivots so that every register index is
//    static.  Shared rows are 8 ceil(K/8) + 4 long, which puts the fragment
//    loads on distinct banks; no index needs a division by K.  Any other K
//    takes the run-time-K engine, which keeps the blocks in shared memory
//    and is slower.
//  * Operands come from global memory by cp.async, started as soon as a
//    buffer is free so that they arrive under the product or the
//    right-hand-side update before; results leave from registers in
//    64-byte runs, and a product's additive term (C_odd, the parked C') is
//    read the same way, all of it before the first store.  The global
//    scratch (allocated by the caller) holds the reduced bands of levels
//    >= 1, the inverses and the reduced right-hand sides, about as many
//    bytes as the real input rows; nothing is kept for identity rows, and
//    an even row of a next level stores only its inverse.
//  * Not done: keeping the small levels in shared memory across levels
//    (the three buffers a warp has are all in use), TMA, and a thread block
//    cluster per system for batches far below the SM count.
//
// The kernel allocates nothing, launches once on the caller's stream and
// returns cudaGetLastError() of the launch.

#ifdef CR_SOLVE_HOST_SHIM
// Tests compile this file for the host: the shim runs each thread of a
// block as a host thread and supplies the intrinsics wrapped below.
#include CR_SOLVE_HOST_SHIM
#else
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Barrier `id` (1..15) over the `nthreads` threads of one team of warps.
__device__ inline void named_barrier(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// Asynchronous copy of BYTES (8 or 16) from global to shared memory.
template <int BYTES>
__device__ inline void cp_async(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
               "l"(gmem), "n"(BYTES)
               : "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// c (16 x 8) += a (16 x 8, row) b (8 x 8, col) on the float64 tensor cores.
// Lane (g, t) = (lane / 4, lane % 4) holds a0 = a[g][t], a1 = a[g + 8][t],
// a2 = a[g][t + 4], a3 = a[g + 8][t + 4]; b0 = b[t][g], b1 = b[t + 4][g];
// c0, c1 = c[g][2t], c[g][2t + 1]; c2, c3 = c[g + 8][2t], c[g + 8][2t + 1].
// (The m8n8k4 shape of sm_80 runs at a fraction of this one's rate here.)
__device__ inline void dmma_m16n8k8(double& c0, double& c1, double& c2,
                                    double& c3, double a0, double a1,
                                    double a2, double a3, double b0,
                                    double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

}  // namespace
#endif

namespace {

constexpr int kMaxWarps = 8;
// Dynamic shared memory a block may use on sm_90 (227 KB).
constexpr size_t kMaxSmem = 232448;

// Rows of levels 1.. of a system of `rows` block rows.
__host__ __device__ inline int reduced_rows(int rows) {
  int s = 0;
  for (int q = 1; (rows >> q) > 0; ++q) s += rows >> q;
  return s;
}

// Scratch layout per system, in elements: Lw, Cw, Uw (reduced_rows blocks
// each; level l >= 1 starts at block sum_{1 <= q < l} rows >> q), Cinv (rows
// blocks; the inverses of level l start at block
// sum_{q < l} ((rows >> q) + 1) / 2), bw (R x reduced_rows x K).
__host__ __device__ inline size_t work_elems(int rows, int K, int R) {
  const size_t kk = (size_t)K * K;
  const size_t red = (size_t)reduced_rows(rows);
  return (3 * red + (size_t)rows) * kk + (size_t)R * red * K;
}

template <typename T>
struct Vec2;
template <>
struct Vec2<double> {
  using type = double2;
  static constexpr bool tensor_cores = true;
};
template <>
struct Vec2<float> {
  using type = float2;
  static constexpr bool tensor_cores = false;  // float32 stays full FMAs
};

// Engine primitives.  load() starts a copy of one K x K block from global
// memory into a buffer and wait() ends all copies started; mm() and gj()
// end with __syncwarp(), so what they wrote to shared memory is visible to
// the warp and what they read may be overwritten.

// ---------------------------------------------------------------------------
// Register-tile engine, block size KC known at compile time (KC even).
// A warp holds a PAD x PAD matrix, PAD = 8 ceil(KC / 8), as TR x TR tiles of
// 8 x 8 in the accumulator layout of mma.sync (an m16n8 accumulator is two
// such tiles, one above the other): lane (g, t) = (lane / 4, lane % 4) owns
// rows 8 ti + g and columns 8 tj + 2 t, 8 tj + 2 t + 1.  Rows
// and columns from KC on are zero in every buffer: the buffers start zeroed,
// copies touch the KC x KC part only, and products and inverses of such
// matrices are zero there again.  Shared rows are LD = PAD + 4 long, which
// puts the fragment loads of a product on distinct banks.
template <typename T, int KC>
struct TileEngine {
  static_assert(KC % 2 == 0, "block size must be even");
  using V = typename Vec2<T>::type;
  static constexpr int TR = (KC + 7) / 8;
  static constexpr int PAD = 8 * TR;
  static constexpr int LD = PAD + 4;
  static constexpr int BUF = PAD * LD;
  static constexpr int NV = KC * KC / 2;

  int lane, g, t;

  __device__ TileEngine(int, int lane_)
      : lane(lane_), g(lane_ >> 2), t(lane_ & 3) {}
  __host__ __device__ static int block(int) { return KC; }
  __host__ __device__ static int ld(int) { return LD; }
  __host__ __device__ static int buf_elems(int) { return BUF; }
  __host__ __device__ static int ex_elems(int) { return 4 * PAD; }

  // s (shared, leading dimension LD) <- gsrc (global, KC x KC contiguous),
  // asynchronously: wait() before use.
  __device__ void load(T* s, const T* gsrc) const {
    const V* gv = reinterpret_cast<const V*>(gsrc);
#pragma unroll 4
    for (int e = lane; e < NV; e += 32) {
      const int i = (2 * e) / KC;
      const int c = 2 * e - i * KC;
      cp_async<(int)sizeof(V)>(s + i * LD + c, gv + e);
    }
  }

  __device__ void wait() const {
    cp_async_wait_all();
    __syncwarp();
  }

  // Accumulate A B (shared operands) into the register tiles c.
  __device__ void product(T (&c)[TR][TR][2], const T* A, const T* B) const {
    if constexpr (Vec2<T>::tensor_cores) {
      // Tile rows go in pairs through m16n8k8; an odd last one is paired
      // with zeros.
      const T* Ag = A + g * LD + t;
      const T* Bg = B + t * LD + g;
#pragma unroll 1
      for (int kk = 0; kk < PAD / 8; ++kk) {
        T a[TR + 1][2], b[TR][2];
#pragma unroll
        for (int ti = 0; ti < TR; ++ti) {
          a[ti][0] = Ag[ti * 8 * LD + 8 * kk];
          a[ti][1] = Ag[ti * 8 * LD + 8 * kk + 4];
        }
        a[TR][0] = a[TR][1] = T(0);
#pragma unroll
        for (int tj = 0; tj < TR; ++tj) {
          b[tj][0] = Bg[8 * kk * LD + 8 * tj];
          b[tj][1] = Bg[(8 * kk + 4) * LD + 8 * tj];
        }
#pragma unroll
        for (int ti = 0; ti < TR; ti += 2)
#pragma unroll
          for (int tj = 0; tj < TR; ++tj) {
            if (ti + 1 < TR) {
              dmma_m16n8k8(c[ti][tj][0], c[ti][tj][1], c[ti + 1][tj][0],
                           c[ti + 1][tj][1], a[ti][0], a[ti + 1][0], a[ti][1],
                           a[ti + 1][1], b[tj][0], b[tj][1]);
            } else {
              T d0 = T(0), d1 = T(0);
              dmma_m16n8k8(c[ti][tj][0], c[ti][tj][1], d0, d1, a[ti][0],
                           a[TR][0], a[ti][1], a[TR][1], b[tj][0], b[tj][1]);
            }
          }
      }
    } else {
      const T* Ag = A + g * LD;
      const T* Bg = B + 2 * t;
#pragma unroll 2
      for (int k = 0; k < KC; ++k) {
        T a[TR];
        V b[TR];
#pragma unroll
        for (int ti = 0; ti < TR; ++ti) a[ti] = Ag[ti * 8 * LD + k];
#pragma unroll
        for (int tj = 0; tj < TR; ++tj)
          b[tj] = *reinterpret_cast<const V*>(Bg + k * LD + 8 * tj);
#pragma unroll
        for (int ti = 0; ti < TR; ++ti)
#pragma unroll
          for (int tj = 0; tj < TR; ++tj) {
            c[ti][tj][0] += a[ti] * b[tj].x;
            c[ti][tj][1] += a[ti] * b[tj].y;
          }
      }
    }
  }

  // dst = src - A B if src, else -A B if negate, else A B.  A and B are
  // shared; dst is shared (any buffer, A and B included) when dst_global
  // is false and a global KC x KC block otherwise; src is a global block.
  __device__ __noinline__ void mm(T* dst, bool dst_global, const T* A,
                                  const T* B, const T* src,
                                  bool negate) const {
    T c[TR][TR][2];
#pragma unroll
    for (int ti = 0; ti < TR; ++ti)
#pragma unroll
      for (int tj = 0; tj < TR; ++tj) c[ti][tj][0] = c[ti][tj][1] = T(0);
    product(c, A, B);
    __syncwarp();  // every lane has read A and B: dst may overwrite them
    // All of src is read before anything is stored: dst may be src, and a
    // store between two loads would make each load wait for the last.
    if (src != nullptr) {
#pragma unroll
      for (int ti = 0; ti < TR; ++ti)
#pragma unroll
        for (int tj = 0; tj < TR; ++tj) {
          const int row = 8 * ti + g, col = 8 * tj + 2 * t;
          V s2;
          s2.x = s2.y = T(0);
          if (row < KC && col < KC)
            s2 = *reinterpret_cast<const V*>(src + row * KC + col);
          c[ti][tj][0] = s2.x - c[ti][tj][0];
          c[ti][tj][1] = s2.y - c[ti][tj][1];
        }
    }
    const T sign = (src == nullptr && negate) ? T(-1) : T(1);
    const int dld = dst_global ? KC : LD;
#pragma unroll
    for (int ti = 0; ti < TR; ++ti)
#pragma unroll
      for (int tj = 0; tj < TR; ++tj) {
        const int row = 8 * ti + g, col = 8 * tj + 2 * t;
        V o;
        o.x = sign * c[ti][tj][0];
        o.y = sign * c[ti][tj][1];
        if ((row < KC && col < KC) || !dst_global)
          *reinterpret_cast<V*>(dst + row * dld + col) = o;
      }
    __syncwarp();
  }

  // out (global) = pivot-free Gauss-Jordan inverse of M (shared).  The
  // block stays in registers; pivot row and column pass through ex (shared,
  // 4 PAD elements, two halves used in turn), one __syncwarp() a pivot.
  // Pivots go in groups of 8; after each group the tiles rotate by one in
  // both directions, so the pivot row and column always lie in tiles
  // (0, *) and (*, 0) and every register index is static.  The blocks
  // inverted are SPD Schur complements: pivots stay positive.
  __device__ __noinline__ void gj(T* M, T* ex, T* out) const {
    T c[TR][TR][2];
#pragma unroll
    for (int ti = 0; ti < TR; ++ti)
#pragma unroll
      for (int tj = 0; tj < TR; ++tj) {
        const V v = *reinterpret_cast<const V*>(M + (8 * ti + g) * LD +
                                                8 * tj + 2 * t);
        c[ti][tj][0] = v.x;
        c[ti][tj][1] = v.y;
      }
#pragma unroll 1
    for (int o = 0; o < TR; ++o) {
      // Register tile (ti, tj) holds block row (ti + o) % TR and block
      // column (tj + o) % TR.
      int rowoff[TR], coloff[TR];
#pragma unroll
      for (int q = 0; q < TR; ++q) {
        const int blk = (q + o) % TR;
        rowoff[q] = 8 * blk + g;
        coloff[q] = 8 * blk + 2 * t;
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * o + jj;
        if (j < KC) {
          T* rb = ex + (jj & 1) * 2 * PAD;  // row j
          T* cb = rb + PAD;                 // column j
          const bool own_row = g == jj;
          const bool own_col = t == (jj >> 1);
          const int h = jj & 1;
          if (own_row) {
#pragma unroll
            for (int q = 0; q < TR; ++q) {
              V v;
              v.x = c[0][q][0];
              v.y = c[0][q][1];
              *reinterpret_cast<V*>(rb + coloff[q]) = v;
            }
          }
          if (own_col) {
#pragma unroll
            for (int q = 0; q < TR; ++q) cb[rowoff[q]] = c[q][0][h];
          }
          __syncwarp();
          const T recip = T(1) / rb[j];
          T r[TR][2], f[TR];
#pragma unroll
          for (int q = 0; q < TR; ++q) {
            const V v = *reinterpret_cast<const V*>(rb + coloff[q]);
            r[q][0] = v.x * recip;
            r[q][1] = v.y * recip;
            f[q] = cb[rowoff[q]];
          }
          // Row j becomes r, column j becomes -f recip, the rest M - f r:
          // one update with row j and column j of M taken as zero,
          // r_j = recip and f_j = -1.
          if (own_col) {
            r[0][h] = recip;
#pragma unroll
            for (int q = 0; q < TR; ++q) c[q][0][h] = T(0);
          }
          if (own_row) {
            f[0] = T(-1);
#pragma unroll
            for (int q = 0; q < TR; ++q) c[0][q][0] = c[0][q][1] = T(0);
          }
#pragma unroll
          for (int ti = 0; ti < TR; ++ti)
#pragma unroll
            for (int tj = 0; tj < TR; ++tj) {
              c[ti][tj][0] -= f[ti] * r[tj][0];
              c[ti][tj][1] -= f[ti] * r[tj][1];
            }
        }
      }
      T d[TR][TR][2];
#pragma unroll
      for (int ti = 0; ti < TR; ++ti)
#pragma unroll
        for (int tj = 0; tj < TR; ++tj) {
          d[ti][tj][0] = c[(ti + 1) % TR][(tj + 1) % TR][0];
          d[ti][tj][1] = c[(ti + 1) % TR][(tj + 1) % TR][1];
        }
#pragma unroll
      for (int ti = 0; ti < TR; ++ti)
#pragma unroll
        for (int tj = 0; tj < TR; ++tj) {
          c[ti][tj][0] = d[ti][tj][0];
          c[ti][tj][1] = d[ti][tj][1];
        }
    }
    // TR rotations bring every tile back to its place.
#pragma unroll
    for (int ti = 0; ti < TR; ++ti)
#pragma unroll
      for (int tj = 0; tj < TR; ++tj) {
        const int row = 8 * ti + g, col = 8 * tj + 2 * t;
        if (row < KC && col < KC) {
          V v;
          v.x = c[ti][tj][0];
          v.y = c[ti][tj][1];
          *reinterpret_cast<V*>(out + row * KC + col) = v;
        }
      }
    __syncwarp();
  }
};

// ---------------------------------------------------------------------------
// Run-time-K engine: blocks stay in shared memory (leading dimension K),
// each lane takes every 32nd element.  For block sizes without a compiled
// tile engine.
template <typename T>
struct PlainEngine {
  int K, lane;

  __device__ PlainEngine(int K_, int lane_) : K(K_), lane(lane_) {}
  __host__ __device__ static int block(int K) { return K; }
  __host__ __device__ static int ld(int K) { return K; }
  __host__ __device__ static int buf_elems(int K) {
    return (K * K + 1) & ~1;
  }
  __host__ __device__ static int ex_elems(int K) { return 2 * K; }

  __device__ void load(T* s, const T* gsrc) const {
    for (int e = lane; e < K * K; e += 32) s[e] = gsrc[e];
  }

  __device__ void wait() const { __syncwarp(); }

  // As TileEngine::mm, but a shared dst must be neither A nor B.
  __device__ __noinline__ void mm(T* dst, bool, const T* A, const T* B,
                                  const T* src, bool negate) const {
    int i = lane / K, c = lane - (lane / K) * K;
    for (int e = lane; e < K * K; e += 32) {
      T acc = T(0);
      for (int k = 0; k < K; ++k) acc += A[i * K + k] * B[k * K + c];
      dst[e] = (src != nullptr) ? src[e] - acc : (negate ? -acc : acc);
      c += 32;
      while (c >= K) {
        c -= K;
        ++i;
      }
    }
    __syncwarp();
  }

  // As TileEngine::gj; ex holds 2 K elements, and M is overwritten.
  __device__ __noinline__ void gj(T* M, T* ex, T* out) const {
    T* fcol = ex;
    T* rrow = ex + K;
    for (int j = 0; j < K; ++j) {
      for (int t = lane; t < K; t += 32) {
        fcol[t] = M[t * K + j];
        rrow[t] = M[j * K + t];
      }
      __syncwarp();
      const T recip = T(1) / fcol[j];
      int i = lane / K, c = lane - (lane / K) * K;
      for (int e = lane; e < K * K; e += 32) {
        if (i == j) {
          M[e] = (c == j) ? recip : rrow[c] * recip;
        } else if (c == j) {
          M[e] = -fcol[i] * recip;
        } else {
          M[e] = M[e] - fcol[i] * (rrow[c] * recip);
        }
        c += 32;
        while (c >= K) {
          c -= K;
          ++i;
        }
      }
      __syncwarp();
    }
    for (int e = lane; e < K * K; e += 32) out[e] = M[e];
    __syncwarp();
  }
};

// ---------------------------------------------------------------------------

// One level of the reduction: `rows` real rows of bands and right-hand
// sides (right-hand side r of row j at b + r bstride + j K).
template <typename T>
struct Level {
  const T* L;
  const T* C;
  const T* U;
  const T* b;
  size_t bstride;
  int rows;
};

// out[r][i] = (base ? base[r][i] : out[r][i]) - sum_k M[i][k] v[r][k] for
// each right-hand side r; M shared with leading dimension ld, vectors global.
template <typename T>
__device__ void rhs_update(T* out, size_t ostride, const T* base,
                           size_t bstride, const T* M, int ld, const T* v,
                           size_t vstride, int K, int R, int lane) {
  for (int r = 0; r < R; ++r) {
    for (int i = lane; i < K; i += 32) {
      T s = T(0);
      for (int k = 0; k < K; ++k) s += M[i * ld + k] * v[r * vstride + k];
      const T from = base != nullptr ? base[r * bstride + i]
                                     : out[r * ostride + i];
      out[r * ostride + i] = from - s;
    }
  }
}

// `team` warps share one system; a block of blockDim.x / 32 warps holds
// blockDim.x / (32 team) systems.
template <typename T, typename E>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
cr_solve_kernel(const T* __restrict__ L0, const T* __restrict__ C0,
                const T* __restrict__ U0, const T* __restrict__ b0, T* x,
                T* work, int batch, int m, int rows, int Karg, int R,
                int team) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = E::block(Karg);
  const int ld = E::ld(Karg);
  const int buf = E::buf_elems(Karg);
  const int KK = K * K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int team_id = warp / team;
  const int tw = warp - team_id * team;  // this warp within its team
  const int tt = tw * 32 + lane;         // this thread within its team
  const E eng(Karg, lane);

  const size_t sys = (size_t)blockIdx.x * (blockDim.x / (32 * team)) + team_id;
  if (sys >= (size_t)batch) return;  // whole teams leave together

  // The team's barrier: __syncwarp() for a team of one warp.
  auto team_sync = [&]() {
    if (team == 1) {
      __syncwarp();
    } else {
      named_barrier(1 + team_id, 32 * team);  // ids 1..kMaxWarps
    }
  };

  // Per warp: three block buffers (zeroed), a vector of ld elements and
  // the inversion's exchange space.
  const int per_warp = 3 * buf + ld + E::ex_elems(Karg);
  T* X = reinterpret_cast<T*>(smem_raw) + (size_t)warp * per_warp;
  T* Y = X + buf;
  T* Z = Y + buf;
  T* vec = Z + buf;
  T* ex = vec + ld;
  for (int e = lane; e < 3 * buf; e += 32) X[e] = T(0);
  __syncwarp();

  const size_t band = (size_t)m * KK;
  const int red = reduced_rows(rows);
  T* wsys = work + sys * work_elems(rows, K, R);
  T* Lw = wsys;
  T* Cw = Lw + (size_t)red * KK;
  T* Uw = Cw + (size_t)red * KK;
  T* Cinv = Uw + (size_t)red * KK;
  T* bw = Cinv + (size_t)rows * KK;
  T* xs = x + sys * (size_t)R * m * K;
  const size_t xstride = (size_t)m * K;

  auto level = [&](int l) -> Level<T> {
    if (l == 0) {
      return Level<T>{L0 + sys * band, C0 + sys * band, U0 + sys * band,
                      b0 + sys * (size_t)R * m * K, (size_t)m * K, rows};
    }
    size_t off = 0;
    for (int q = 1; q < l; ++q) off += (size_t)(rows >> q);
    return Level<T>{Lw + off * KK, Cw + off * KK, Uw + off * KK, bw + off * K,
                    (size_t)red * K, rows >> l};
  };
  auto inverses = [&](int l) -> T* {
    size_t off = 0;
    for (int q = 0; q < l; ++q) off += (size_t)(((rows >> q) + 1) >> 1);
    return Cinv + off * KK;
  };

  // x of the identity rows.
  const int idle = (m - rows) * K;
  for (int e = tt; e < R * idle; e += 32 * team) {
    const int r = e / idle;
    xs[(size_t)r * xstride + (size_t)rows * K + (e - r * idle)] = T(0);
  }

  // ---- level 0: inverses of the even diagonal blocks ----
  {
    const Level<T> cur = level(0);
    T* inv = inverses(0);
    for (int j = tw; j < (rows + 1) / 2; j += team) {
      eng.load(X, cur.C + (size_t)(2 * j) * KK);
      eng.wait();
      eng.gj(X, ex, inv + (size_t)j * KK);
    }
  }
  team_sync();

  // ---- downward: reduce the odd rows of each level into the next ----
  int top = 0;  // the last level, of one row
  for (int l = 0; (rows >> l) >= 2; ++l) {
    top = l + 1;
    const Level<T> cur = level(l);
    const Level<T> nxt = level(l + 1);
    T* nL = const_cast<T*>(nxt.L);
    T* nC = const_cast<T*>(nxt.C);
    T* nU = const_cast<T*>(nxt.U);
    T* nb = const_cast<T*>(nxt.b);
    const T* inv = inverses(l);
    T* ninv = inverses(l + 1);
    for (int j = tw; j < nxt.rows; j += team) {
      const bool below = 2 * j + 2 < cur.rows;  // else an identity row
      // L of a level's first row and U of its last multiply nothing, so
      // they are neither read nor formed for the next level.
      const bool has_L = j > 0;
      const bool has_U = 2 * j + 3 < cur.rows;
      const T* Lod = cur.L + (size_t)(2 * j + 1) * KK;
      const T* Cod = cur.C + (size_t)(2 * j + 1) * KK;
      const T* Uod = cur.U + (size_t)(2 * j + 1) * KK;
      const T* Lev = cur.L + (size_t)(2 * j) * KK;
      const T* Uev = cur.U + (size_t)(2 * j) * KK;
      const T* b_od = cur.b + (size_t)(2 * j + 1) * K;
      const T* b_ev = cur.b + (size_t)(2 * j) * K;
      T* Lj = nL + (size_t)j * KK;
      T* Cj = nC + (size_t)j * KK;
      T* Uj = nU + (size_t)j * KK;
      T* bj = nb + (size_t)j * K;
      // Row j of the next level is inverted here if it is an even row
      // there (only its inverse is used), else its C' is stored.
      const bool invert = (j & 1) == 0;
      // alpha = L_odd Cinv_even (in Z);  b' = b_odd - alpha b_even
      eng.load(X, Lod);
      eng.load(Y, inv + (size_t)j * KK);
      eng.wait();
      eng.mm(Z, false, X, Y, nullptr, false);
      if (has_L) eng.load(X, Lev);
      eng.load(Y, Uev);
      rhs_update<T>(bj, nxt.bstride, b_od, cur.bstride, Z, ld, b_ev,
                    cur.bstride, K, R, lane);
      eng.wait();
      // L' = -alpha L_even
      if (has_L) eng.mm(Lj, true, Z, X, nullptr, true);
      if (below) {
        const T* Lbe = cur.L + (size_t)(2 * j + 2) * KK;
        const T* Ube = cur.U + (size_t)(2 * j + 2) * KK;
        const T* b_be = cur.b + (size_t)(2 * j + 2) * K;
        eng.load(X, Uod);
        // C' = C_odd - alpha U_even, parked in its place in the scratch
        eng.mm(Cj, true, Z, Y, Cod, false);
        // beta = U_odd Cinv_below (in Z);  b' -= beta b_below
        eng.load(Y, inv + (size_t)(j + 1) * KK);
        eng.wait();
        eng.mm(Z, false, X, Y, nullptr, false);
        if (has_U) eng.load(X, Ube);
        eng.load(Y, Lbe);
        rhs_update<T>(bj, nxt.bstride, nullptr, 0, Z, ld, b_be, cur.bstride,
                      K, R, lane);
        eng.wait();
        // U' = -beta U_below;  C' -= beta L_below
        if (has_U) eng.mm(Uj, true, Z, X, nullptr, true);
        eng.mm(invert ? X : Cj, !invert, Z, Y, Cj, false);
      } else {
        // The row below is an identity row: beta = U_odd meets only zeros,
        // and this is the next level's last row, whose U is never read.
        eng.mm(invert ? X : Cj, !invert, Z, Y, Cod, false);
      }
      if (invert) eng.gj(X, ex, ninv + (size_t)(j >> 1) * KK);
    }
    team_sync();
  }

  // ---- upward: solve the even rows of each level, the last level first ----
  for (int l = top; l >= 0; --l) {
    const Level<T> cur = level(l);
    const T* inv = inverses(l);
    const size_t step = (size_t)1 << l;
    for (int j = tw; j < (cur.rows + 1) / 2; j += team) {
      const bool above = j > 0;
      const bool below = 2 * j + 1 < cur.rows;
      if (above) eng.load(X, cur.L + (size_t)(2 * j) * KK);
      if (below) eng.load(Y, cur.U + (size_t)(2 * j) * KK);
      eng.load(Z, inv + (size_t)j * KK);
      eng.wait();
      const T* b_ev = cur.b + (size_t)(2 * j) * K;
      // Level row jj is original row (jj + 1) step - 1.
      const T* x_above = above ? xs + ((size_t)(2 * j) * step - 1) * K : xs;
      const T* x_below = xs + ((size_t)(2 * j + 2) * step - 1) * K;
      T* x_out = xs + ((size_t)(2 * j + 1) * step - 1) * K;
      for (int r = 0; r < R; ++r) {
        for (int i = lane; i < K; i += 32) {
          T t = b_ev[r * cur.bstride + i];
          if (above) {
            T s = T(0);
            for (int k = 0; k < K; ++k)
              s += X[i * ld + k] * x_above[r * xstride + k];
            t -= s;
          }
          if (below) {
            T s = T(0);
            for (int k = 0; k < K; ++k)
              s += Y[i * ld + k] * x_below[r * xstride + k];
            t -= s;
          }
          vec[i] = t;
        }
        __syncwarp();
        for (int i = lane; i < K; i += 32) {
          T s = T(0);
          for (int k = 0; k < K; ++k) s += Z[i * ld + k] * vec[k];
          x_out[r * xstride + i] = s;
        }
        __syncwarp();
      }
    }
    team_sync();
  }
}

}  // namespace

#ifndef CR_SOLVE_HOST_SHIM
// ---- host side ----

namespace {

template <typename T, typename E>
int launch_engine(const T* L, const T* C, const T* U, const T* b, T* x,
                  T* work, int batch, int m, int rows, int K, int R, int team,
                  cudaStream_t stream) {
  const size_t per_warp = (3 * (size_t)E::buf_elems(K) + (size_t)E::ld(K) +
                           (size_t)E::ex_elems(K)) *
                          sizeof(T);
  // As many warps a block as fit in shared memory, at most kMaxWarps.
  int warps = (int)(kMaxSmem / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (team <= 0) {
    // As many warps to a system as the card has to spare: all of a block's
    // for a batch below the count of SMs, one when every warp of the card
    // can have a system of its own.
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    team = (int)(((long long)sms * warps) / batch);
    if (team < 1) team = 1;
  }
  if (team > warps) team = warps;
  warps = (warps / team) * team;
  const int per_block = warps / team;
  const int blocks = (batch + per_block - 1) / per_block;
  const size_t smem = per_warp * warps;
  cudaError_t err = cudaFuncSetAttribute(
      cr_solve_kernel<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cr_solve_kernel<T, E><<<blocks, warps * 32, smem, stream>>>(
      L, C, U, b, x, work, batch, m, rows, K, R, team);
  return (int)cudaGetLastError();
}

// Block sizes with a register-tile instantiation take it; any other takes
// the run-time-K engine.
template <typename T>
int launch(const T* L, const T* C, const T* U, const T* b, T* x, T* work,
           int batch, int m, int rows, int K, int R, int team, void* stream) {
  if (batch < 1 || m < 1 || rows < 1 || rows > m || K < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 2:
      return launch_engine<T, TileEngine<T, 2>>(L, C, U, b, x, work, batch, m,
                                                rows, K, R, team, s);
    case 6:
      return launch_engine<T, TileEngine<T, 6>>(L, C, U, b, x, work, batch, m,
                                                rows, K, R, team, s);
    case 38:
      return launch_engine<T, TileEngine<T, 38>>(L, C, U, b, x, work, batch, m,
                                                 rows, K, R, team, s);
    default:
      break;
  }
  return launch_engine<T, PlainEngine<T>>(L, C, U, b, x, work, batch, m, rows,
                                          K, R, team, s);
}

}  // namespace

extern "C" {

size_t cr_work_elems(int rows, int K, int R) { return work_elems(rows, K, R); }

// 1 if block size K has a compiled register-tile engine.
int cr_has_tiles(int K) { return K == 2 || K == 6 || K == 38; }

// team: warps that share one system; 0, which every caller but a test
// passes, has it chosen from the batch and the card's SM count.
int cr_solve_f64(const double* L, const double* C, const double* U,
                 const double* b, double* x, double* work, int batch, int m,
                 int rows, int K, int R, int team, void* stream) {
  return launch<double>(L, C, U, b, x, work, batch, m, rows, K, R, team,
                        stream);
}

int cr_solve_f32(const float* L, const float* C, const float* U,
                 const float* b, float* x, float* work, int batch, int m,
                 int rows, int K, int R, int team, void* stream) {
  return launch<float>(L, C, U, b, x, work, batch, m, rows, K, R, team,
                       stream);
}

}  // extern "C"

#endif  // CR_SOLVE_HOST_SHIM
