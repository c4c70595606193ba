// Checkpointed fused ERK evolution (K4) and its adjoint from the stored
// states (K5) for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes; see pulser_diff_torch/ops/fused_evolution.py).
//
// Replaces the two Pallas kernels of pulser_diff_tpu/ops/pallas_evolution.py
// that the JAX package runs from dim 2^16 (16 atoms), with their kron-pair
// (XY) branches (K3: _Side._kron_products, the kron terms of
// apply_minus_iH / apply_iH_transpose, _kron_cotangents,
// _kron_matrix_cotangents):
//   K4  _fwd_ckpt_kernel  -> fused_fwd_ckpt_kernel
//   K5  _bwd_ckpt_kernel  -> fused_bwd_ckpt_kernel
// K4 runs K1's stage arithmetic (two-word streams and h*b_s weights, Kahan
// carry) and stores the state after every step; K5 runs the adjoint step
// from each stored start state (no mirror pass: the S - 1 forward stage
// recomputes, then the reversed transpose recursion with each stage's
// cotangent work) and takes a cotangent at every step.
//
// What bounds them on this card.  At 16 atoms (da = db = 256, nb = 1) one
// application of -iH is 8 real 256 x 256 x 256 products, 268 MFLOP.  The
// main path's 166 DP5 steps make K4 S = 6 applications per step (~267
// GFLOP, ~4.0 ms at 67 TFLOP/s of f32 outside the tensor cores) and K5
// (2S - 1) applications plus S sets of 8 outer products per step (~757
// GFLOP, ~11.3 ms).  Operations bound both; the stored states are 87 MB.
// Nothing of size da*da or da*db fits one block's shared memory (Hrow,
// Hcol and the state are 512 KiB each in split complex), and every stage
// needs the one before it.
//
// What the design does about it.
//   - One cooperative launch per evolution (cudaLaunchCooperativeKernel):
//     as many 256-thread blocks as are both co-resident and useful.  The
//     step and stage loops run inside the kernel; a grid-wide barrier
//     separates the dependent phases, which alternate between
//       elementwise: finish the previous stage's derivative, build the
//                    next stage vector, assemble the next side matrices;
//       products:    32 x 32 output tiles spread over all blocks.
//     K4 takes 2S barriers per step, K5 4S - 1 (3S and 6S - 2 with kron
//     pairs).
//   - A product tile stages k-chunks of 32 of both operands in shared
//     memory; each thread keeps a 2 x 2 register tile and sums in true f32
//     with explicit __fmaf_rn, every k-sum in order from k = 0.  No tensor
//     cores: TF32 keeps ~3 decimal digits and would break the 1e-6 bar.
//   - The row-side and column-side products of -iH are separate tiles
//     (twice the tiles to spread), combined in the next elementwise phase
//     in K1's order, so K4's states equal K1's bit for bit.
//   - Side matrices, stage vectors and products live in global scratch,
//     which the 50 MB L2 holds.
//   - The stream cotangents are sums over a whole (da, da) or (db, db)
//     outer product: each tile writes its partial sums, which a later
//     phase adds in a fixed order; dbar is elementwise.  No float atomics,
//     so a run repeats bit for bit.
//   - Compiled with -fmad=false, as fused_evolution.cu: the compensated
//     lines round each operation as written.  Never build with fast-math.
//
// The kron pairs (K3).  Each term z_k (R_k (x) C_k) + h.c. adds 8 real
// products per application (R u and R^T u, then times C^T or C, for x and
// y): at 12 atoms XY (da = db = 64, K = 8) 33.6 MFLOP a stage beside the
// sides' 4.2 MFLOP; over the 101 steps K4 ~23 GFLOP (~0.34 ms at 67
// TFLOP/s) and K5, with the part-matrix cotangents, ~85 GFLOP (~1.27 ms).  They are one more pair of product phases: the R-side
// products run as extra tiles of the apply phase, then (grid barrier) the
// C-side products, then (grid barrier) the elementwise phase adds the
// terms in K1's order, so K4's states equal K1's bit for bit at K > 0 too.
// A tile here computes two real products at once (tile_pair), the row
// products of x and y with one R, or of R u for x and y with one C.  In K5
// the C-side tiles of the transposed application also give the za / zb
// stream cotangents (per-tile partials, summed in fixed order with the
// parts' ones), and the part-matrix cotangents (16 products per term and
// state, _kron_matrix_cotangents) run as two more sets of tiles in the same
// phases; each krbar / kcbar tile has one owner that accumulates it over
// every step, stage and state in a fixed order: no float atomics.  Nothing
// of the kron branch lives in shared memory beyond the tiles.

#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_S 7
#define MAX_P 8             // row / column parts per side
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define TT 32               // output tile edge
#define KC 32               // k-chunk staged in shared memory
#define HT 16               // a thread owns rows ty + HT*r, columns tx + HT*c (r, c < 2)
#define ZW (2 * MAX_P)      // cotangent partials per tile
#define MAX_K 32            // kron pairs

struct Tab {
    int S;
    float a[MAX_S][MAX_S];
    int bnz[MAX_S];  // 1 where the update weight b_s is nonzero
};

struct Geo {
    int R, n_steps, nb, da, db, pr, pc;
};

// read-only inputs
struct In {
    const float *psi_re, *psi_im;                  // (R, nb, da, db)
    const float *rsym, *rasym, *csym, *casym;      // (pr, da, da), (pc, db, db): P + P^T, P - P^T
    const float* z[8];  // forward-node streams (R, n_steps, S, P): row hi re/im, row lo re/im, col ...
    const float *hb_hi, *hb_lo, *hs;               // (n_steps, S), (n_steps, S), (n_steps,)
    const float *diag, *diag_lo;                   // (R, da, db)
    const float *st_re, *st_im, *lam_re, *lam_im;  // K5: (R, n_steps, nb, da, db)
    // kron pairs (K = 0: none)
    const float *kr, *kc;                          // (R, K, da, da), (R, K, db, db)
    const float* zk[4];  // forward-node streams (R, n_steps, S, K): hi re, hi im, lo re, lo im
    float *krbar, *kcbar;                          // K5 outputs, shaped as kr, kc
    int K;
};

// ---------------------------------------------------------------------------
// grid-wide barrier (all blocks are co-resident: cooperative launch)
// ---------------------------------------------------------------------------
struct Barrier {
    unsigned int* count;  // arrivals at the current barrier; 0 between barriers
    unsigned int* gen;    // barrier generation
};

__device__ void grid_sync(const Barrier& bar) {
    __syncthreads();
    if (threadIdx.x == 0) {
        volatile unsigned int* gen = bar.gen;
        const unsigned int g = *gen;
        __threadfence();
        if (atomicAdd(bar.count, 1u) == gridDim.x - 1u) {
            atomicExch(bar.count, 0u);
            __threadfence();
            atomicAdd(bar.gen, 1u);
        } else {
            unsigned long long spins = 0;
            while (*gen == g) {
                __nanosleep(64);
                // a block that never arrives: fail the launch, never hang
                if (++spins == (1ull << 28)) __trap();
            }
        }
        __threadfence();
    }
    __syncthreads();
}

__device__ __forceinline__ size_t gtid() { return (size_t)blockIdx.x * NTHREADS + threadIdx.x; }
__device__ __forceinline__ size_t gsize() { return (size_t)gridDim.x * NTHREADS; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// tile products
// ---------------------------------------------------------------------------
struct TileSmem {
    float ar[TT][KC + 1], ai[TT][KC + 1];  // A(i0 + i, k0 + k)
    float br[KC][TT + 1], bi[KC][TT + 1];  // B(k0 + k, j0 + j)
    float red[NWARPS][ZW];
};

// A split-complex operand read in place.  A(i, k) lies at i*ld + k, or at
// k*ld + i when trans; B(k, j) at k*ld + j, or at j*ld + k when trans.
struct Opnd {
    const float* re;
    const float* im;
    int ld, trans;
};

// Over one TT x TT tile at (i0, j0) of an (m, n) output with depth K:
//   p[0] = Ar Br,  p[1] = Ai Bi,  p[2] = Ai Br,  p[3] = Ar Bi.
// Every k-sum runs in order from k = 0 with one rounding per product-add.
__device__ __forceinline__ void tile_products(TileSmem& t, const Opnd& A, const Opnd& B,
                                              int m, int n, int K, int i0, int j0,
                                              float p[4][2][2]) {
    const int tx = threadIdx.x % HT, ty = threadIdx.x / HT;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) p[q][r][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
        const int kc = min(KC, K - k0);
        __syncthreads();  // the previous chunk (or job) is consumed
        for (int idx = threadIdx.x; idx < TT * KC; idx += NTHREADS) {
            const int lo = idx % TT, hi = idx / TT;  // lo runs along contiguous memory
            {
                const int i = A.trans ? lo : hi, k = A.trans ? hi : lo;
                float vr = 0.f, vi = 0.f;
                if (i0 + i < m && k < kc) {
                    const size_t o = A.trans ? (size_t)(k0 + k) * A.ld + (i0 + i)
                                             : (size_t)(i0 + i) * A.ld + (k0 + k);
                    vr = A.re[o];
                    vi = A.im[o];
                }
                t.ar[i][k] = vr;
                t.ai[i][k] = vi;
            }
            {
                const int j = B.trans ? hi : lo, k = B.trans ? lo : hi;
                float vr = 0.f, vi = 0.f;
                if (j0 + j < n && k < kc) {
                    const size_t o = B.trans ? (size_t)(j0 + j) * B.ld + (k0 + k)
                                             : (size_t)(k0 + k) * B.ld + (j0 + j);
                    vr = B.re[o];
                    vi = B.im[o];
                }
                t.br[k][j] = vr;
                t.bi[k][j] = vi;
            }
        }
        __syncthreads();
        for (int k = 0; k < kc; ++k) {
            float xr[2], xi[2], yr[2], yi[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                xr[r] = t.ar[ty + HT * r][k];
                xi[r] = t.ai[ty + HT * r][k];
            }
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                yr[c] = t.br[k][tx + HT * c];
                yi[c] = t.bi[k][tx + HT * c];
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    p[0][r][c] = __fmaf_rn(xr[r], yr[c], p[0][r][c]);
                    p[1][r][c] = __fmaf_rn(xi[r], yi[c], p[1][r][c]);
                    p[2][r][c] = __fmaf_rn(xi[r], yr[c], p[2][r][c]);
                    p[3][r][c] = __fmaf_rn(xr[r], yi[c], p[3][r][c]);
                }
            }
        }
    }
}

// A real operand read in place: X(i, k) at i*ld + k, or at k*ld + i when trans.
struct ROp {
    const float* p;
    int ld, trans;
};

// Over one TT x TT tile at (i0, j0) of an (m, n) output with depth K, two
// real products at once:  p[0] = A1 B1,  p[1] = A2 B2.  Every k-sum runs in
// order from k = 0 with one rounding per product-add, as tile_products.
__device__ __forceinline__ void tile_pair(TileSmem& t, const ROp& A1, const ROp& B1,
                                          const ROp& A2, const ROp& B2, int m, int n, int K,
                                          int i0, int j0, float p[2][2][2]) {
    const int tx = threadIdx.x % HT, ty = threadIdx.x / HT;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) p[q][r][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
        const int kc = min(KC, K - k0);
        __syncthreads();  // the previous chunk (or job) is consumed
        for (int idx = threadIdx.x; idx < TT * KC; idx += NTHREADS) {
            const int lo = idx % TT, hi = idx / TT;  // lo runs along contiguous memory
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const ROp& A = q ? A2 : A1;
                const int i = A.trans ? lo : hi, k = A.trans ? hi : lo;
                float v = 0.f;
                if (i0 + i < m && k < kc)
                    v = A.p[A.trans ? (size_t)(k0 + k) * A.ld + (i0 + i)
                                    : (size_t)(i0 + i) * A.ld + (k0 + k)];
                (q ? t.ai : t.ar)[i][k] = v;
            }
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const ROp& B = q ? B2 : B1;
                const int j = B.trans ? hi : lo, k = B.trans ? lo : hi;
                float v = 0.f;
                if (j0 + j < n && k < kc)
                    v = B.p[B.trans ? (size_t)(j0 + j) * B.ld + (k0 + k)
                                    : (size_t)(k0 + k) * B.ld + (j0 + j)];
                (q ? t.bi : t.br)[k][j] = v;
            }
        }
        __syncthreads();
        for (int k = 0; k < kc; ++k) {
            float a1[2], a2[2], b1[2], b2[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                a1[r] = t.ar[ty + HT * r][k];
                a2[r] = t.ai[ty + HT * r][k];
            }
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                b1[c] = t.br[k][tx + HT * c];
                b2[c] = t.bi[k][tx + HT * c];
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    p[0][r][c] = __fmaf_rn(a1[r], b1[c], p[0][r][c]);
                    p[1][r][c] = __fmaf_rn(a2[r], b2[c], p[1][r][c]);
                }
            }
        }
    }
}

// Block sum of each thread's partials into out[0 .. nq), in a fixed order.
__device__ __forceinline__ void block_reduce(TileSmem& t, const float (&acc)[ZW], int nq,
                                             float* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < ZW; ++q) {
        float v = acc[q];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) t.red[warp][q] = v;
    }
    __syncthreads();
    if (threadIdx.x < nq) {
        float v = 0.f;
        for (int w = 0; w < NWARPS; ++w) v += t.red[w][threadIdx.x];
        out[threadIdx.x] = v;
    }
    __syncthreads();
}

// Side matrices of one stage inside a run's scratch: Hrow re/im (da, da),
// Hcol^T re/im (db, db).
struct Side {
    float *hre, *him, *gre, *gim;
};

__device__ __forceinline__ Side side_at(float* base, int da, int db) {
    Side s;
    s.hre = base;
    s.him = s.hre + (size_t)da * da;
    s.gre = s.him + (size_t)da * da;
    s.gim = s.gre + (size_t)db * db;
    return s;
}

// One phase of tile products over every run r (run r's scratch at
// scratch + r * per_run; v, side, q, u, zp are offsets inside it).
//   apply: q = (RA, RB, CA, CB), the row-side products Hrow v and the
//          column-side products v Hcol^T of every state of the stage
//          vector v (nb, da, db), combined as K1 combines them:
//          RA = Hre vx - Him vy, RB = Him vx + Hre vy,
//          CA = vx Gre - vy Gim, CB = vx Gim + vy Gre;
//   outer (K5): the stream cotangents of the stage cotangent g = v against
//          the stage input u, summed over the states b, as K2 forms them:
//            W  = sum_b g_x u_y^T - g_y u_x^T,  V  = sum_b g_x u_x^T + g_y u_y^T  (da, da)
//            Wc = sum_b u_y^T g_x - u_x^T g_y,  Vc = sum_b u_x^T g_x + u_y^T g_y  (db, db)
//          Each tile writes its partials (<Sym_p, W>, <Asym_p, V>)_p or
//          (<Sym_p, Wc>, -<Asym_p, Vc>)_p to one row of ZW at zp (row-side
//          tiles first).
// Offsets of the kron work inside a run's scratch (unused at K = 0).
struct KronOff {
    size_t kt;   // R-side products, 4 K N: per term op(R) v_x, op(R) v_y for op = R, then R^T
    size_t kp;   // C-side products, 4 K N: per term x1 = R v_x C^T, y1, x2 = R^T v_x C, y2
    size_t kf;   // K5: cotangent fields B1, B2, D1, D2, 4 K N
    size_t kmp;  // K5: B1 C, D1 C, u_x C, u_y C, R u_x, R u_y, R B2, R D2, 8 K N
    size_t zkp;  // K5: za / zb partials, S x K x (2 nb nti ntj) x 2
};

// Store a tile_pair result: p[0] into o1, p[1] into o2, both (m, n) dense.
__device__ __forceinline__ void store_pair(const float p[2][2][2], float* o1, float* o2, int m,
                                           int n, int i0, int j0) {
    const int tx = threadIdx.x % HT, ty = threadIdx.x / HT;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int i = i0 + ty + HT * r, j = j0 + tx + HT * c;
            if (i < m && j < n) {
                o1[(size_t)i * n + j] = p[0][r][c];
                o2[(size_t)i * n + j] = p[1][r][c];
            }
        }
}

// One tile of the first kron product phase of run r (job index jj):
//   jj < n_k1:  op(R_k) v_x, op(R_k) v_y into kt (op = R, R^T)
//   otherwise (mat, K5's transposed application): the cotangent fields'
//   first products into kmp, from the fields kf and the stage input u.
__device__ void kron_first(TileSmem& t, const Geo& g, const In& in, float* run, int r, int jj,
                           size_t v_off, size_t u_off, const KronOff& ko) {
    const int da = g.da, db = g.db, nti = cdiv(da, TT), ntj = cdiv(db, TT);
    const size_t M = (size_t)da * db, N = g.nb * M;
    const int per = g.nb * nti * ntj, n_k1 = in.K * 2 * per;
    const bool mat = jj >= n_k1;
    if (mat) jj -= n_k1;
    const int nw = mat ? 4 : 2;
    const int term = jj / (nw * per), w = (jj / per) % nw, rem = jj % per;
    const int b = rem / (nti * ntj), tt = rem % (nti * ntj);
    const int i0 = (tt / ntj) * TT, j0 = (tt % ntj) * TT;
    const float* R = in.kr + ((size_t)r * in.K + term) * da * da;
    const float* C = in.kc + ((size_t)r * in.K + term) * db * db;
    float p[2][2][2];
    if (!mat) {
        const ROp A = {R, da, w};
        const ROp Bx = {run + v_off + b * M, db, 0}, By = {run + v_off + N + b * M, db, 0};
        tile_pair(t, A, Bx, A, By, da, db, da, i0, j0, p);
        float* o = run + ko.kt + (size_t)(4 * term + 2 * w) * N + b * M;
        store_pair(p, o, o + N, da, db, i0, j0);
        return;
    }
    const float* f = run + ko.kf + (size_t)4 * term * N + b * M;  // B1, B2, D1, D2
    const float* ux = run + u_off + b * M;
    const float* uy = ux + N;
    const ROp Cm = {C, db, 0}, Rm = {R, da, 0};
    if (w == 0) tile_pair(t, ROp{f, db, 0}, Cm, ROp{f + 2 * N, db, 0}, Cm, da, db, db, i0, j0, p);
    else if (w == 1) tile_pair(t, ROp{ux, db, 0}, Cm, ROp{uy, db, 0}, Cm, da, db, db, i0, j0, p);
    else if (w == 2) tile_pair(t, Rm, ROp{ux, db, 0}, Rm, ROp{uy, db, 0}, da, db, da, i0, j0, p);
    else tile_pair(t, Rm, ROp{f + N, db, 0}, Rm, ROp{f + 3 * N, db, 0}, da, db, da, i0, j0, p);
    float* o = run + ko.kmp + (size_t)(8 * term + 2 * w) * N + b * M;
    store_pair(p, o, o + N, da, db, i0, j0);
}

template <bool KRON>
__device__ void products(TileSmem& t, const Geo& g, const In& in, float* scratch, size_t per_run,
                         size_t v_off, size_t side_off, size_t q_off, bool outer, size_t u_off,
                         size_t zp_off, const KronOff& ko) {
    const int da = g.da, db = g.db, M = da * db, N = g.nb * M;
    const int nti = cdiv(da, TT), ntj = cdiv(db, TT);
    const int per_apply = g.nb * nti * ntj;
    const int n_or = nti * nti, n_oc = ntj * ntj;
    const int n_out = outer ? n_or + n_oc : 0;
    // the kron pairs' R-side tiles, and in K5's transposed application the
    // cotangent fields' first products
    const int n_kron = KRON ? in.K * per_apply * (2 + (outer ? 4 : 0)) : 0;
    const int jobs = 2 * per_apply + n_out + n_kron;
    const int tx = threadIdx.x % HT, ty = threadIdx.x / HT;
    for (int job = blockIdx.x; job < g.R * jobs; job += gridDim.x) {
        const int r = job / jobs;
        int j = job - r * jobs;
        float* run = scratch + (size_t)r * per_run;
        const float* vre = run + v_off;
        const float* vim = vre + N;
        float p[4][2][2];
        if (j < 2 * per_apply) {
            const Side sd = side_at(run + side_off, da, db);
            const bool col = j >= per_apply;
            if (col) j -= per_apply;
            const int b = j / (nti * ntj), rem = j - b * nti * ntj;
            const int i0 = (rem / ntj) * TT, j0 = (rem % ntj) * TT;
            const Opnd vb = {vre + (size_t)b * M, vim + (size_t)b * M, db, 0};
            if (col) {
                const Opnd gs = {sd.gre, sd.gim, db, 0};
                tile_products(t, vb, gs, da, db, db, i0, j0, p);
            } else {
                const Opnd hs = {sd.hre, sd.him, da, 0};
                tile_products(t, hs, vb, da, db, da, i0, j0, p);
            }
            float* q = run + q_off + (col ? (size_t)2 * N : 0);
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
#pragma unroll
                for (int c2 = 0; c2 < 2; ++c2) {
                    const int i = i0 + ty + HT * r2, jj = j0 + tx + HT * c2;
                    if (i < da && jj < db) {
                        const size_t o = (size_t)b * M + (size_t)i * db + jj;
                        q[o] = p[0][r2][c2] - p[1][r2][c2];
                        q[N + o] = col ? p[3][r2][c2] + p[2][r2][c2] : p[2][r2][c2] + p[3][r2][c2];
                    }
                }
            }
        } else if (j >= 2 * per_apply + n_out) {
            if constexpr (KRON)
                kron_first(t, g, in, run, r, j - 2 * per_apply - n_out, v_off, u_off, ko);
        } else {
            j -= 2 * per_apply;
            const int tile = j;
            const bool rows = j < n_or;
            if (!rows) j -= n_or;
            const int nt = rows ? nti : ntj, n = rows ? da : db;
            const int i0 = (j / nt) * TT, j0 = (j % nt) * TT;
            const float* ure = run + u_off;
            const float* uim = ure + N;
            float w[2][2] = {}, v[2][2] = {};
            for (int b = 0; b < g.nb; ++b) {
                const size_t ob = (size_t)b * M;
                if (rows) {
                    // A(i, kk) = g_b[i, kk], B(kk, j) = u_b[j, kk]
                    const Opnd A = {vre + ob, vim + ob, db, 0}, B = {ure + ob, uim + ob, db, 1};
                    tile_products(t, A, B, da, da, db, i0, j0, p);
                } else {
                    // A(i, kk) = u_b[kk, i], B(kk, j) = g_b[kk, j]
                    const Opnd A = {ure + ob, uim + ob, db, 1}, B = {vre + ob, vim + ob, db, 0};
                    tile_products(t, A, B, db, db, da, i0, j0, p);
                }
#pragma unroll
                for (int r2 = 0; r2 < 2; ++r2) {
#pragma unroll
                    for (int c2 = 0; c2 < 2; ++c2) {
                        w[r2][c2] = w[r2][c2] + (rows ? p[3][r2][c2] - p[2][r2][c2]
                                                      : p[2][r2][c2] - p[3][r2][c2]);
                        v[r2][c2] = v[r2][c2] + (p[0][r2][c2] + p[1][r2][c2]);
                    }
                }
            }
            float acc[ZW] = {};
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
#pragma unroll
                for (int c2 = 0; c2 < 2; ++c2) {
                    const int i = i0 + ty + HT * r2, jj = j0 + tx + HT * c2;
                    if (i >= n || jj >= n) continue;
                    const size_t qd = (size_t)i * n + jj, nn = (size_t)n * n;
#pragma unroll
                    for (int pp = 0; pp < MAX_P; ++pp) {
                        if (rows && pp < g.pr) {
                            acc[2 * pp] = acc[2 * pp] + in.rsym[pp * nn + qd] * w[r2][c2];
                            acc[2 * pp + 1] = acc[2 * pp + 1] + in.rasym[pp * nn + qd] * v[r2][c2];
                        }
                        if (!rows && pp < g.pc) {
                            acc[2 * pp] = acc[2 * pp] + in.csym[pp * nn + qd] * w[r2][c2];
                            acc[2 * pp + 1] = acc[2 * pp + 1] - in.casym[pp * nn + qd] * v[r2][c2];
                        }
                    }
                }
            }
            block_reduce(t, acc, rows ? 2 * g.pr : 2 * g.pc, run + zp_off + (size_t)tile * ZW);
        }
    }
}

// The second kron product phase over every run r: the C-side products
// x1 = (R v_x) C^T, y1, x2 = (R^T v_x) C, y2 into kp.  With cot (K5's
// transposed application of the stage cotangent v = g against the stage
// input u at u_off, stage s), each of these tiles also writes its partial
//   za_bar = <T1(g_x), u_y> - <T1(g_y), u_x>,  zb_bar = -<T2(g_x), u_x> - <T2(g_y), u_y>
// to zkp (the sign of the derivative; see fused_evolution.cu), and the
// part-matrix cotangent tiles accumulate
//   krbar_k += B1 C u_x^T + (u_x C) B2^T + D1 C u_y^T + (u_y C) D2^T
//   kcbar_k += B1^T (R u_x) + u_x^T (R B2) + D1^T (R u_y) + u_y^T (R D2)
// in that order, state after state (_kron_matrix_cotangents).
__device__ void kron_second(TileSmem& t, const Geo& g, const In& in, float* scratch,
                            size_t per_run, const KronOff& ko, bool cot, size_t u_off, int s) {
    const int da = g.da, db = g.db, nti = cdiv(da, TT), ntj = cdiv(db, TT);
    const size_t M = (size_t)da * db, N = g.nb * M;
    const int per = g.nb * nti * ntj, n_k2 = in.K * 2 * per;
    const int n_or = nti * nti, n_oc = ntj * ntj;
    const int jobs = n_k2 + (cot ? in.K * (n_or + n_oc) : 0);
    const int tx = threadIdx.x % HT, ty = threadIdx.x / HT;
    for (int job = blockIdx.x; job < g.R * jobs; job += gridDim.x) {
        const int r = job / jobs;
        int jj = job - r * jobs;
        float* run = scratch + (size_t)r * per_run;
        float p[2][2][2];
        if (jj < n_k2) {
            const int term = jj / (2 * per), w = (jj / per) % 2, rem = jj % per;
            const int b = rem / (nti * ntj), tt = rem % (nti * ntj);
            const int i0 = (tt / ntj) * TT, j0 = (tt % ntj) * TT;
            const float* C = in.kc + ((size_t)r * in.K + term) * db * db;
            const ROp Cm = {C, db, w ? 0 : 1};  // C^T after R, C after R^T
            const float* T = run + ko.kt + (size_t)(4 * term + 2 * w) * N + b * M;
            tile_pair(t, ROp{T, db, 0}, Cm, ROp{T + N, db, 0}, Cm, da, db, db, i0, j0, p);
            float* o = run + ko.kp + (size_t)(4 * term + 2 * w) * N + b * M;
            store_pair(p, o, o + N, da, db, i0, j0);
            if (cot) {
                const float* ux = run + u_off + b * M;
                const float* uy = ux + N;
                float acc[ZW] = {};
#pragma unroll
                for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
                    for (int c2 = 0; c2 < 2; ++c2) {
                        const int i = i0 + ty + HT * r2, j = j0 + tx + HT * c2;
                        if (i >= da || j >= db) continue;
                        const size_t e = (size_t)i * db + j;
                        const float gx = p[0][r2][c2], gy = p[1][r2][c2];  // x1, y1 or x2, y2
                        acc[0] = acc[0] + (gx * uy[e] - gy * ux[e]);
                        acc[1] = w ? acc[1] + (gx * ux[e] + gy * uy[e])
                                   : acc[1] - (gx * ux[e] + gy * uy[e]);
                    }
                const int n_l2t = 2 * per;
                block_reduce(t, acc, 2,
                             run + ko.zkp + (((size_t)s * in.K + term) * n_l2t + (jj % n_l2t)) * 2);
            }
            continue;
        }
        jj -= n_k2;
        const int term = jj / (n_or + n_oc), tile = jj % (n_or + n_oc);
        const bool rows = tile < n_or;
        const int n = rows ? da : db, nt = rows ? nti : ntj, tl = rows ? tile : tile - n_or;
        const int i0 = (tl / nt) * TT, j0 = (tl % nt) * TT;
        float* dst = rows ? in.krbar + ((size_t)r * in.K + term) * da * da
                          : in.kcbar + ((size_t)r * in.K + term) * db * db;
        float acc[2][2];
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
                const int i = i0 + ty + HT * r2, j = j0 + tx + HT * c2;
                acc[r2][c2] = (i < n && j < n) ? dst[(size_t)i * n + j] : 0.f;
            }
        for (int b = 0; b < g.nb; ++b) {
            const float* f = run + ko.kf + (size_t)4 * term * N + b * M;  // B1, B2, D1, D2
            const float* ux = run + u_off + b * M;
            const float* uy = ux + N;
            const float* mp = run + ko.kmp + (size_t)8 * term * N + b * M;
            float q[2][2][2][2];
            if (rows) {  // (da, db) x (db, da)
                tile_pair(t, ROp{mp, db, 0}, ROp{ux, db, 1}, ROp{mp + 2 * N, db, 0},
                          ROp{f + N, db, 1}, da, da, db, i0, j0, q[0]);
                tile_pair(t, ROp{mp + N, db, 0}, ROp{uy, db, 1}, ROp{mp + 3 * N, db, 0},
                          ROp{f + 3 * N, db, 1}, da, da, db, i0, j0, q[1]);
            } else {  // (db, da) x (da, db)
                tile_pair(t, ROp{f, db, 1}, ROp{mp + 4 * N, db, 0}, ROp{ux, db, 1},
                          ROp{mp + 6 * N, db, 0}, db, db, da, i0, j0, q[0]);
                tile_pair(t, ROp{f + 2 * N, db, 1}, ROp{mp + 5 * N, db, 0}, ROp{uy, db, 1},
                          ROp{mp + 7 * N, db, 0}, db, db, da, i0, j0, q[1]);
            }
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
                for (int c2 = 0; c2 < 2; ++c2)
                    acc[r2][c2] = (((acc[r2][c2] + q[0][0][r2][c2]) + q[0][1][r2][c2])
                                   + q[1][0][r2][c2]) + q[1][1][r2][c2];
        }
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
                const int i = i0 + ty + HT * r2, j = j0 + tx + HT * c2;
                if (i < n && j < n) dst[(size_t)i * n + j] = acc[r2][c2];
            }
    }
}

// ---------------------------------------------------------------------------
// elementwise pieces
// ---------------------------------------------------------------------------
// Hrow = sum_p z_re[p] Sym_p + i sum_p z_im[p] Asym_p (hi word, then the lo
// word folded in before the final rounding); Hcol likewise, stored as H^T:
// gre = re, gim = -im.  Every element of both sides of every run.
__device__ void assemble_all(const In& in, const Geo& g, int S, int k, int s, float* scratch,
                             size_t per_run, size_t side_off) {
    const int da2 = g.da * g.da, db2 = g.db * g.db, per = da2 + db2;
    for (size_t idx = gtid(); idx < (size_t)g.R * per; idx += gsize()) {
        const int r = (int)(idx / per);
        int e = (int)(idx - (size_t)r * per);
        const Side sd = side_at(scratch + (size_t)r * per_run + side_off, g.da, g.db);
        const bool row = e < da2;
        if (!row) e -= da2;
        const int P = row ? g.pr : g.pc, sz = row ? da2 : db2;
        const size_t base = (((size_t)r * g.n_steps + k) * S + s) * P;
        const float* sym = row ? in.rsym : in.csym;
        const float* asym = row ? in.rasym : in.casym;
        const float* const* z = in.z + (row ? 0 : 4);  // hi re, hi im, lo re, lo im
        float hr = 0.f, hi = 0.f, lr = 0.f, li = 0.f;
        for (int p = 0; p < P; ++p) {
            const float sv = sym[(size_t)p * sz + e];
            const float av = asym[(size_t)p * sz + e];
            hr = hr + z[0][base + p] * sv;
            hi = hi + z[1][base + p] * av;
            lr = lr + z[2][base + p] * sv;
            li = li + z[3][base + p] * av;
        }
        if (row) {
            sd.hre[e] = hr + lr;
            sd.him[e] = hi + li;
        } else {
            sd.gre[e] = hr + lr;
            sd.gim[e] = -(hi + li);
        }
    }
}

// sign * (-i H v) at element e of a run, from its combined products q and
// the stage vector (x, y) there, in K1's order:
//   h_re = ((RA + CA) + d x) + dlo x,  h_im = ((RB + CB) + d y) + dlo y,
//   -i H v = (h_im, -h_re).
// F = -iH is antisymmetric as a real map (H hermitian), so F^T = -F: the
// adjoint's transpose products take sign = -1.
// Then, term by term, the kron pairs from their C-side products kp and the
// stage's stream values at zoff (hi + lo), as K1 adds them:
//   h_re += za T1(x) - zb T2(y),  h_im += za T1(y) + zb T2(x).
// KRON = false compiles the ising kernels without the kron code (their
// registers, spills and arithmetic stay as without kron pairs).
template <bool KRON>
__device__ __forceinline__ void finish_apply(const float* q, size_t N, size_t e, float x, float y,
                                             float d, float dl, float sign, const In& in,
                                             const float* kp, size_t zoff, float& kx, float& ky) {
    float h_re = ((q[e] + q[2 * N + e]) + d * x) + dl * x;
    float h_im = ((q[N + e] + q[3 * N + e]) + d * y) + dl * y;
    for (int j = 0; KRON && j < in.K; ++j) {
        const float za = in.zk[0][zoff + j] + in.zk[2][zoff + j];
        const float zb = in.zk[1][zoff + j] + in.zk[3][zoff + j];
        const float* P = kp + (size_t)4 * j * N + e;
        const float x1 = P[0], y1 = P[N], x2 = P[2 * N], y2 = P[3 * N];
        h_re = h_re + (za * (x1 + x2) - zb * (y1 - y2));
        h_im = h_im + (za * (y1 + y2) + zb * (x1 - x2));
    }
    kx = sign * h_im;
    ky = -sign * h_re;
}

// the kron streams' offset at run r, step k, stage s
__device__ __forceinline__ size_t zk_at(const Geo& g, int S, int K, int r, int k, int s) {
    return (((size_t)r * g.n_steps + k) * S + s) * K;
}

// ---------------------------------------------------------------------------
// K4: forward evolution storing the state after every step
// ---------------------------------------------------------------------------
struct FwdLayout {  // float offsets inside one run's scratch (N = nb*da*db)
    size_t x, y, cx, cy;  // state and Kahan carries
    size_t u;             // stage vector (re N, im N)
    size_t k;             // stage derivatives: stage s re at k + 2sN, im at k + 2sN + N
    size_t q;             // products RA, RB, CA, CB
    size_t side;          // one stage's side matrices
    KronOff ko;           // kron products (kt, kp)
    size_t per_run;
};

__host__ __device__ inline FwdLayout fwd_layout(int S, int nb, int da, int db, int K) {
    const size_t N = (size_t)nb * da * db;
    FwdLayout L;
    L.x = 0;
    L.y = N;
    L.cx = 2 * N;
    L.cy = 3 * N;
    L.u = 4 * N;
    L.k = 6 * N;
    L.q = L.k + 2 * (size_t)S * N;
    L.side = L.q + 4 * N;
    L.ko = {};
    L.ko.kt = L.side + 2 * (size_t)da * da + 2 * (size_t)db * db;
    L.ko.kp = L.ko.kt + 4 * (size_t)K * N;
    L.per_run = L.ko.kp + 4 * (size_t)K * N;
    return L;
}

template <bool KRON>
__global__ void __launch_bounds__(NTHREADS, 2)
fused_fwd_ckpt_kernel(In in, float* out_re, float* out_im, float* lo_re, float* lo_im,
                      float* scratch, Barrier bar, Geo g, Tab tab) {
    __shared__ TileSmem t;
    const int S = tab.S, M = g.da * g.db;
    const size_t N = (size_t)g.nb * M, RN = (size_t)g.R * N;
    const FwdLayout L = fwd_layout(S, g.nb, g.da, g.db, in.K);

    // the state, zero carries, the first stage input and its sides
    for (size_t idx = gtid(); idx < RN; idx += gsize()) {
        const int r = (int)(idx / N);
        const size_t e = idx - (size_t)r * N;
        float* run = scratch + (size_t)r * L.per_run;
        const float x = in.psi_re[idx], y = in.psi_im[idx];
        run[L.x + e] = x;
        run[L.y + e] = y;
        run[L.cx + e] = 0.f;
        run[L.cy + e] = 0.f;
        run[L.u + e] = x;
        run[L.u + N + e] = y;
    }
    assemble_all(in, g, S, 0, 0, scratch, L.per_run, L.side);
    grid_sync(bar);

    for (int k = 0; k < g.n_steps; ++k) {
        const float h = in.hs[k];
        for (int s = 0; s < S; ++s) {
            products<KRON>(t, g, in, scratch, L.per_run, L.u, L.side, L.q, false, 0, 0, L.ko);
            grid_sync(bar);
            if constexpr (KRON) {
                kron_second(t, g, in, scratch, L.per_run, L.ko, false, 0, s);
                grid_sync(bar);
            }
            for (size_t idx = gtid(); idx < RN; idx += gsize()) {
                const int r = (int)(idx / N);
                const size_t e = idx - (size_t)r * N;
                const int m = (int)(e % M);
                float* run = scratch + (size_t)r * L.per_run;
                float* K = run + L.k;
                float kx, ky;
                finish_apply<KRON>(run + L.q, N, e, run[L.u + e], run[L.u + N + e],
                             in.diag[(size_t)r * M + m], in.diag_lo[(size_t)r * M + m], 1.f,
                             in, run + L.ko.kp, zk_at(g, S, in.K, r, k, s), kx, ky);
                K[2 * s * N + e] = kx;
                K[2 * s * N + N + e] = ky;
                if (s + 1 < S) {
                    // the next stage input
                    float xs = run[L.x + e], ys = run[L.y + e];
                    for (int j = 0; j <= s; ++j) {
                        const float a = tab.a[s + 1][j];
                        if (a != 0.f) {
                            const float c = a * h;
                            xs = xs + c * K[2 * j * N + e];
                            ys = ys + c * K[2 * j * N + N + e];
                        }
                    }
                    run[L.u + e] = xs;
                    run[L.u + N + e] = ys;
                } else {
                    // two-word h*b_s increment (hi words, then lo words), Kahan update
                    float dx = 0.f, dy = 0.f;
                    bool first = true;
                    for (int s2 = 0; s2 < S; ++s2) {
                        if (!tab.bnz[s2]) continue;
                        const float w = in.hb_hi[k * S + s2];
                        const float gx = K[2 * s2 * N + e], gy = K[2 * s2 * N + N + e];
                        if (first) { dx = w * gx; dy = w * gy; first = false; }
                        else { dx = dx + w * gx; dy = dy + w * gy; }
                    }
                    for (int s2 = 0; s2 < S; ++s2) {
                        if (!tab.bnz[s2]) continue;
                        const float w = in.hb_lo[k * S + s2];
                        dx = dx + w * K[2 * s2 * N + e];
                        dy = dy + w * K[2 * s2 * N + N + e];
                    }
                    float x = run[L.x + e], cx = run[L.cx + e];
                    float yk = dx - cx, tt = x + yk;
                    cx = (tt - x) - yk;
                    run[L.cx + e] = cx;
                    x = tt;
                    float y = run[L.y + e], cy = run[L.cy + e];
                    yk = dy - cy;
                    tt = y + yk;
                    cy = (tt - y) - yk;
                    run[L.cy + e] = cy;
                    y = tt;
                    run[L.x + e] = x;
                    run[L.y + e] = y;
                    const size_t o = ((size_t)r * g.n_steps + k) * N + e;
                    out_re[o] = x;
                    out_im[o] = y;
                    if (lo_re) {  // the low words (negated Kahan carries), when asked for
                        lo_re[o] = -cx;
                        lo_im[o] = -cy;
                    }
                    run[L.u + e] = x;  // the next step's first stage input
                    run[L.u + N + e] = y;
                }
            }
            if (s + 1 < S) assemble_all(in, g, S, k, s + 1, scratch, L.per_run, L.side);
            else if (k + 1 < g.n_steps) assemble_all(in, g, S, k + 1, 0, scratch, L.per_run, L.side);
            grid_sync(bar);
        }
    }
}

// ---------------------------------------------------------------------------
// K5: adjoint over the reversed steps from the stored start states
// ---------------------------------------------------------------------------
struct BwdLayout {  // float offsets inside one run's scratch
    size_t x0;     // the step's start state (re N, im N)
    size_t l;      // costate
    size_t us;     // stage inputs, S x 2N
    size_t fk;     // forward stage derivatives, S x 2N (S - 1 used)
    size_t ws;     // transpose products, S x 2N
    size_t gv;     // the stage cotangent being applied
    size_t q;      // products RA, RB, CA, CB
    size_t sides;  // the S stages' side matrices
    size_t dacc;   // dbar accumulator (da, db)
    size_t zp;     // cotangent partials, S x (row tiles + column tiles) x ZW
    KronOff ko;    // kron products and cotangent work
    size_t side_sz, per_run;
    int n_or, n_oc, n_l2t;  // n_l2t: C-side kron tiles per term (za / zb partials)
};

__host__ __device__ inline BwdLayout bwd_layout(int S, int nb, int da, int db, int K) {
    const size_t M = (size_t)da * db, N = (size_t)nb * M;
    BwdLayout L;
    L.n_or = cdiv(da, TT) * cdiv(da, TT);
    L.n_oc = cdiv(db, TT) * cdiv(db, TT);
    L.side_sz = 2 * (size_t)da * da + 2 * (size_t)db * db;
    L.x0 = 0;
    L.l = 2 * N;
    L.us = 4 * N;
    L.fk = L.us + 2 * (size_t)S * N;
    L.ws = L.fk + 2 * (size_t)S * N;
    L.gv = L.ws + 2 * (size_t)S * N;
    L.q = L.gv + 2 * N;
    L.sides = L.q + 4 * N;
    L.dacc = L.sides + (size_t)S * L.side_sz;
    L.zp = L.dacc + M;
    L.n_l2t = 2 * nb * cdiv(da, TT) * cdiv(db, TT);
    L.ko.kt = L.zp + (size_t)S * (L.n_or + L.n_oc) * ZW;
    L.ko.kp = L.ko.kt + 4 * (size_t)K * N;
    L.ko.kf = L.ko.kp + 4 * (size_t)K * N;
    L.ko.kmp = L.ko.kf + 4 * (size_t)K * N;
    L.ko.zkp = L.ko.kmp + 8 * (size_t)K * N;
    L.per_run = L.ko.zkp + (size_t)S * K * L.n_l2t * 2;
    return L;
}

// zbar[r, kk, s, :] for every run and stage from the tile partials, in a
// fixed order: the parts' columns, then each kron pair's (za_bar, zb_bar).
__device__ void reduce_zbar(const Geo& g, int S, int K, const BwdLayout& L, const float* scratch,
                            float* zbar, int kk) {
    const int nrow = 2 * g.pr + 2 * g.pc + 2 * K;
    for (size_t idx = gtid(); idx < (size_t)g.R * S * nrow; idx += gsize()) {
        const int r = (int)(idx / ((size_t)S * nrow));
        const int rem = (int)(idx - (size_t)r * S * nrow);
        const int s = rem / nrow, q = rem % nrow;
        const float* zp = scratch + (size_t)r * L.per_run + L.zp + (size_t)s * (L.n_or + L.n_oc) * ZW;
        float v = 0.f;
        if (q < 2 * g.pr) {
            for (int t = 0; t < L.n_or; ++t) v += zp[(size_t)t * ZW + q];
        } else if (q < 2 * g.pr + 2 * g.pc) {
            for (int t = 0; t < L.n_oc; ++t) v += zp[(size_t)(L.n_or + t) * ZW + (q - 2 * g.pr)];
        } else {
            const int kq = q - 2 * g.pr - 2 * g.pc, term = kq / 2;
            const float* zk = scratch + (size_t)r * L.per_run + L.ko.zkp
                              + ((size_t)s * K + term) * L.n_l2t * 2 + kq % 2;
            for (int t = 0; t < L.n_l2t; ++t) v += zk[(size_t)t * 2];
        }
        zbar[(((size_t)r * g.n_steps + kk) * S + s) * nrow + q] = v;
    }
}

// End of a step at element e: the last transpose product w_0 (its kron
// streams at zoff), then the costate update lam += sum_s w_s (in stage order).
template <bool KRON>
__device__ __forceinline__ void finish_costate(float* run, const BwdLayout& L, size_t N, size_t e,
                                               int S, float d, float dl, const In& in, size_t zoff,
                                               float& lx, float& ly) {
    float wx, wy;
    finish_apply<KRON>(run + L.q, N, e, run[L.gv + e], run[L.gv + N + e], d, dl, -1.f, in,
                       run + L.ko.kp, zoff, wx, wy);
    lx = lx + wx;
    ly = ly + wy;
    for (int s = 1; s < S; ++s) {
        lx = lx + run[L.ws + 2 * s * N + e];
        ly = ly + run[L.ws + 2 * s * N + N + e];
    }
}

template <bool KRON>
__global__ void __launch_bounds__(NTHREADS, 2)
fused_bwd_ckpt_kernel(In in, float* lam0_re, float* lam0_im, float* zbar, float* dbar,
                      float* scratch, Barrier bar, Geo g, Tab tab) {
    __shared__ TileSmem t;
    const int S = tab.S, M = g.da * g.db;
    const size_t N = (size_t)g.nb * M, RM = (size_t)g.R * M, RN = (size_t)g.R * N;
    const BwdLayout L = bwd_layout(S, g.nb, g.da, g.db, in.K);

    // the costate, dbar and the part-matrix cotangents start at zero
    if constexpr (KRON) {
        for (size_t idx = gtid(); idx < (size_t)g.R * in.K * g.da * g.da; idx += gsize())
            in.krbar[idx] = 0.f;
        for (size_t idx = gtid(); idx < (size_t)g.R * in.K * g.db * g.db; idx += gsize())
            in.kcbar[idx] = 0.f;
    }
    for (size_t idx = gtid(); idx < RM; idx += gsize()) {
        const int r = (int)(idx / M), m = (int)(idx - (size_t)r * M);
        float* run = scratch + (size_t)r * L.per_run;
        for (int b = 0; b < g.nb; ++b) {
            run[L.l + (size_t)b * M + m] = 0.f;
            run[L.l + N + (size_t)b * M + m] = 0.f;
        }
        run[L.dacc + m] = 0.f;
    }
    grid_sync(bar);

    for (int it = 0; it < g.n_steps; ++it) {
        const int k = g.n_steps - 1 - it;
        const float h = in.hs[k];
        // (the end of step k + 1, then) the cotangent of stored[k], the start
        // state stored[k - 1] (psi0 at k = 0), the first stage input
        for (size_t idx = gtid(); idx < RN; idx += gsize()) {
            const int r = (int)(idx / N);
            const size_t e = idx - (size_t)r * N;
            const int m = (int)(e % M);
            float* run = scratch + (size_t)r * L.per_run;
            float lx = run[L.l + e], ly = run[L.l + N + e];
            if (it > 0)
                finish_costate<KRON>(run, L, N, e, S, in.diag[(size_t)r * M + m],
                               in.diag_lo[(size_t)r * M + m], in, zk_at(g, S, in.K, r, k + 1, 0),
                               lx, ly);
            const size_t o = ((size_t)r * g.n_steps + k) * N + e;
            lx = lx + in.lam_re[o];
            ly = ly + in.lam_im[o];
            run[L.l + e] = lx;
            run[L.l + N + e] = ly;
            float x, y;
            if (k == 0) {
                x = in.psi_re[idx];
                y = in.psi_im[idx];
            } else {
                x = in.st_re[o - N];
                y = in.st_im[o - N];
            }
            run[L.x0 + e] = x;
            run[L.x0 + N + e] = y;
            run[L.us + e] = x;
            run[L.us + N + e] = y;
        }
        if (it > 0) reduce_zbar(g, S, in.K, L, scratch, zbar, k + 1);
        assemble_all(in, g, S, k, 0, scratch, L.per_run, L.sides);
        grid_sync(bar);

        // forward stage recompute (the last stage's product is dead)
        for (int s = 0; s + 1 < S; ++s) {
            products<KRON>(t, g, in, scratch, L.per_run, L.us + 2 * s * N,
                           L.sides + s * L.side_sz, L.q, false, 0, 0, L.ko);
            grid_sync(bar);
            if constexpr (KRON) {
                kron_second(t, g, in, scratch, L.per_run, L.ko, false, 0, s);
                grid_sync(bar);
            }
            for (size_t idx = gtid(); idx < RN; idx += gsize()) {
                const int r = (int)(idx / N);
                const size_t e = idx - (size_t)r * N;
                const int m = (int)(e % M);
                float* run = scratch + (size_t)r * L.per_run;
                float* FK = run + L.fk;
                float kx, ky;
                finish_apply<KRON>(run + L.q, N, e, run[L.us + 2 * s * N + e],
                                   run[L.us + 2 * s * N + N + e],
                             in.diag[(size_t)r * M + m], in.diag_lo[(size_t)r * M + m], 1.f, in,
                             run + L.ko.kp, zk_at(g, S, in.K, r, k, s), kx, ky);
                FK[2 * s * N + e] = kx;
                FK[2 * s * N + N + e] = ky;
                float xs = run[L.x0 + e], ys = run[L.x0 + N + e];
                for (int j = 0; j <= s; ++j) {
                    const float a = tab.a[s + 1][j];
                    if (a != 0.f) {
                        const float c = a * h;
                        xs = xs + c * FK[2 * j * N + e];
                        ys = ys + c * FK[2 * j * N + N + e];
                    }
                }
                run[L.us + 2 * (s + 1) * N + e] = xs;
                run[L.us + 2 * (s + 1) * N + N + e] = ys;
            }
            assemble_all(in, g, S, k, s + 1, scratch, L.per_run, L.sides + (s + 1) * L.side_sz);
            grid_sync(bar);
        }

        // reversed transpose recursion with each stage's cotangent work
        for (int s = S - 1; s >= 0; --s) {
            const float bhl = in.hb_hi[k * S + s] + in.hb_lo[k * S + s];
            for (size_t idx = gtid(); idx < RM; idx += gsize()) {
                const int r = (int)(idx / M), m = (int)(idx - (size_t)r * M);
                float* run = scratch + (size_t)r * L.per_run;
                float* WS = run + L.ws;
                const float* us = run + L.us + 2 * s * N;
                const float d = in.diag[idx], dl = in.diag_lo[idx];
                float acc = 0.f;
                for (int b = 0; b < g.nb; ++b) {
                    const size_t e = (size_t)b * M + m;
                    if (s + 1 < S) {
                        float wx, wy;
                        finish_apply<KRON>(run + L.q, N, e, run[L.gv + e], run[L.gv + N + e], d, dl,
                                     -1.f, in, run + L.ko.kp, zk_at(g, S, in.K, r, k, s + 1), wx,
                                     wy);
                        WS[2 * (s + 1) * N + e] = wx;
                        WS[2 * (s + 1) * N + N + e] = wy;
                    }
                    float gx = 0.f, gy = 0.f;
                    if (tab.bnz[s]) {
                        gx = bhl * run[L.l + e];
                        gy = bhl * run[L.l + N + e];
                    }
                    for (int rr = s + 1; rr < S; ++rr) {
                        const float a = tab.a[rr][s];
                        if (a != 0.f) {
                            const float c = a * h;
                            gx = gx + c * WS[2 * rr * N + e];
                            gy = gy + c * WS[2 * rr * N + N + e];
                        }
                    }
                    run[L.gv + e] = gx;
                    run[L.gv + N + e] = gy;
                    acc = acc + (gx * us[N + e] - gy * us[e]);
                    // the kron cotangent fields B1, B2, D1, D2 of g
                    const size_t zo = zk_at(g, S, in.K, r, k, s);
                    for (int j = 0; KRON && j < in.K; ++j) {
                        const float za = in.zk[0][zo + j] + in.zk[2][zo + j];
                        const float zb = in.zk[1][zo + j] + in.zk[3][zo + j];
                        float* f = run + L.ko.kf + (size_t)4 * j * N + e;
                        f[0] = zb * gx - za * gy;
                        f[N] = -zb * gx - za * gy;
                        f[2 * N] = za * gx + zb * gy;
                        f[3 * N] = za * gx - zb * gy;
                    }
                }
                run[L.dacc + m] = run[L.dacc + m] + acc;
            }
            grid_sync(bar);
            products<KRON>(t, g, in, scratch, L.per_run, L.gv, L.sides + s * L.side_sz, L.q, true,
                           L.us + 2 * s * N, L.zp + (size_t)s * (L.n_or + L.n_oc) * ZW, L.ko);
            grid_sync(bar);
            if constexpr (KRON) {
                kron_second(t, g, in, scratch, L.per_run, L.ko, true, L.us + 2 * s * N, s);
                grid_sync(bar);
            }
        }
    }
    // the end of step 0, then the outputs
    for (size_t idx = gtid(); idx < RN; idx += gsize()) {
        const int r = (int)(idx / N);
        const size_t e = idx - (size_t)r * N;
        const int m = (int)(e % M);
        float* run = scratch + (size_t)r * L.per_run;
        float lx = run[L.l + e], ly = run[L.l + N + e];
        finish_costate<KRON>(run, L, N, e, S, in.diag[(size_t)r * M + m],
                             in.diag_lo[(size_t)r * M + m], in, zk_at(g, S, in.K, r, 0, 0), lx, ly);
        lam0_re[idx] = lx;
        lam0_im[idx] = ly;
    }
    for (size_t idx = gtid(); idx < RM; idx += gsize()) {
        const int r = (int)(idx / M), m = (int)(idx - (size_t)r * M);
        dbar[idx] = scratch[(size_t)r * L.per_run + L.dacc + m];
    }
    reduce_zbar(g, S, in.K, L, scratch, zbar, 0);
}

// ---------------------------------------------------------------------------
// C interface (ctypes).  Every function returns 0 on success, a negative
// code for what the kernel does not take (-1 tableau, -2 parts, -3 no
// cooperative launch on this device, -4 kron pairs), or the cudaError_t of
// the launch.
// Launches go to the caller's stream, on the current device; nothing
// synchronises.
// ---------------------------------------------------------------------------
static int make_tab(Tab* tab, int S, const double* a, const int* bnz) {
    if (S < 1 || S > MAX_S) return -1;
    tab->S = S;
    for (int i = 0; i < MAX_S; ++i) {
        tab->bnz[i] = i < S ? bnz[i] : 0;
        for (int j = 0; j < MAX_S; ++j) tab->a[i][j] = (i < S && j < S) ? (float)a[i * S + j] : 0.f;
    }
    return 0;
}

// blocks worth launching: enough for the largest product phase and for
// one thread per state element, at most what can be co-resident
static int useful_blocks(int bwd, int R, int nb, int da, int db, int K) {
    const int nti = cdiv(da, TT), ntj = cdiv(db, TT);
    int jobs = 2 * nb * nti * ntj + (bwd ? nti * nti + ntj * ntj : 0)
               + K * nb * nti * ntj * (bwd ? 6 : 2);
    jobs *= R;
    const long long elems = (long long)R * nb * da * db;
    const long long by_elems = (elems + NTHREADS - 1) / NTHREADS;
    const long long want = jobs > by_elems ? jobs : by_elems;
    return (int)(want < 1 ? 1 : want);
}

// the kernel instantiation a launch takes: the kron-pair branch is its own
static const void* kernel_of(int bwd, int K) {
    if (bwd)
        return K ? (const void*)fused_bwd_ckpt_kernel<true> : (const void*)fused_bwd_ckpt_kernel<false>;
    return K ? (const void*)fused_fwd_ckpt_kernel<true> : (const void*)fused_fwd_ckpt_kernel<false>;
}

static int coop_blocks(int bwd, int R, int nb, int da, int db, int K, int* blocks) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return -3;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(bwd, K), NTHREADS, 0);
    if (err != cudaSuccess) return (int)err;
    const int most = per_sm * sms, want = useful_blocks(bwd, R, nb, da, db, K);
    *blocks = want < most ? want : most;
    if (*blocks < 1) *blocks = 1;
    return 0;
}

extern "C" int pdt_ckpt_blocks(int bwd, int R, int nb, int da, int db, int K) {
    int blocks = 0;
    const int err = coop_blocks(bwd, R, nb, da, db, K, &blocks);
    return err ? (err > 0 ? -err : err) : blocks;
}

extern "C" size_t pdt_ckpt_scratch_floats(int bwd, int R, int S, int nb, int da, int db, int K) {
    const size_t per = bwd ? bwd_layout(S, nb, da, db, K).per_run
                           : fwd_layout(S, nb, da, db, K).per_run;
    return (size_t)R * per;
}

// kron inputs: kr, kc, then the four forward-node streams (K = 0: none read)
static In make_in(const float* const* p, const float* const* kin, int K, int bwd) {
    In in = {};
    int i = 0;
    if (bwd) {
        in.st_re = p[i++];
        in.st_im = p[i++];
        in.lam_re = p[i++];
        in.lam_im = p[i++];
    }
    in.psi_re = p[i++];
    in.psi_im = p[i++];
    in.rsym = p[i++];
    in.rasym = p[i++];
    in.csym = p[i++];
    in.casym = p[i++];
    for (int j = 0; j < 8; ++j) in.z[j] = p[i++];
    in.hb_hi = p[i++];
    in.hb_lo = p[i++];
    in.hs = p[i++];
    in.diag = p[i++];
    in.diag_lo = p[i++];
    in.K = K;
    if (K) {
        in.kr = kin[0];
        in.kc = kin[1];
        for (int j = 0; j < 4; ++j) in.zk[j] = kin[2 + j];
    }
    return in;
}

// in: psi_re, psi_im, rsym, rasym, csym, casym, 8 streams, hb_hi, hb_lo, hs, diag, diag_lo
extern "C" int pdt_ckpt_fwd(const float* const* in_ptrs, const float* const* kron_in, int K,
                            float* out_re, float* out_im, float* lo_re, float* lo_im,
                            float* scratch, unsigned int* bar,
                            int R, int n_steps, int nb, int da, int db, int pr, int pc, int S,
                            const double* a, const int* bnz, void* stream) {
    Tab tab;
    if (make_tab(&tab, S, a, bnz)) return -1;
    if (pr > MAX_P || pc > MAX_P) return -2;
    if (K < 0 || K > MAX_K) return -4;
    int blocks = 0;
    const int err = coop_blocks(0, R, nb, da, db, K, &blocks);
    if (err) return err;
    In in = make_in(in_ptrs, kron_in, K, 0);
    Barrier b = {bar, bar + 1};
    Geo g = {R, n_steps, nb, da, db, pr, pc};
    void* args[] = {&in, &out_re, &out_im, &lo_re, &lo_im, &scratch, &b, &g, &tab};
    cudaError_t e = cudaLaunchCooperativeKernel(kernel_of(0, K), dim3(blocks), dim3(NTHREADS), args,
                                                0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// in: st_re, st_im, lam_re, lam_im, then the forward kernel's inputs
extern "C" int pdt_ckpt_bwd(const float* const* in_ptrs, const float* const* kron_in, int K,
                            float* lam0_re, float* lam0_im, float* zbar, float* dbar,
                            float* krbar, float* kcbar, float* scratch, unsigned int* bar,
                            int R, int n_steps, int nb, int da, int db, int pr, int pc, int S,
                            const double* a, const int* bnz, void* stream) {
    Tab tab;
    if (make_tab(&tab, S, a, bnz)) return -1;
    if (pr > MAX_P || pc > MAX_P) return -2;
    if (K < 0 || K > MAX_K) return -4;
    int blocks = 0;
    const int err = coop_blocks(1, R, nb, da, db, K, &blocks);
    if (err) return err;
    In in = make_in(in_ptrs, kron_in, K, 1);
    in.krbar = krbar;
    in.kcbar = kcbar;
    Barrier b = {bar, bar + 1};
    Geo g = {R, n_steps, nb, da, db, pr, pc};
    void* args[] = {&in, &lam0_re, &lam0_im, &zbar, &dbar, &scratch, &b, &g, &tab};
    cudaError_t e = cudaLaunchCooperativeKernel(kernel_of(1, K), dim3(blocks), dim3(NTHREADS), args,
                                                0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
