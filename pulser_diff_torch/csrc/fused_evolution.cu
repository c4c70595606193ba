// Fused compensated-f32 ERK evolution (K1) and its discrete adjoint (K2)
// for Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes; see pulser_diff_torch/ops/fused_evolution.py).
//
// Replaces the two Pallas kernels of pulser_diff_tpu/ops/pallas_evolution.py
// that the main path runs, with their kron-pair (XY) branches:
//   K1  _fwd_kernel  (states=True)                          -> fused_fwd_kernel
//   K2  _bwd_kernel via _bwd_interval_lean / _adjoint_core  -> fused_bwd_kernel
//   K3  the kron-pair branch of both: _Side._kron_products, the kron terms
//       of apply_minus_iH / apply_iH_transpose, _kron_cotangents and
//       _kron_matrix_cotangents                              -> kron_products,
//       the K-term loop of apply_block, kron_stream_partials,
//       kron_matrix_cotangents
// Both compute what the Pallas kernels compute; they are not a block-by-block
// translation.
//
// What bounds them on this card.  One evolution is n_steps x S dependent
// stages (166 x 6 = 996 on the 12-atom main path); every stage needs the
// previous one.  A stage is two block-real products per state, about
// 4.2 MFLOP at da = db = 64, so the whole forward is ~4 GFLOP of f32 and
// the adjoint ~4x that: microseconds of work for the card's f32 rate, but
// spread over ~1000 (forward) and ~2800 (adjoint: 3S - 1 = 17 stage products
// per step) serial phases.  The
// bound that matters is the serial chain of stages and the block-wide
// synchronisations between them, not bytes or FLOP/s.
//
// What the design does about it.
//   - One launch per evolution, one block per Monte-Carlo run (the TPU
//     grid axis R).  The step loop runs inside the block, as the TPU grid
//     did, so there is no per-stage launch and no host round trip.
//   - Each stage's inputs are built elementwise by the thread that owns the
//     element (the ERK combinations only mix the same element across
//     stages), so the only cross-thread dependency is the matrix product.
//     The assembled side matrices Hrow/Hcol and the stage input live in
//     shared memory (96 KB at da = db = 64); the state, its Kahan words and
//     the stage derivatives live in global scratch, which stays resident in
//     the 50 MB L2.  Two __syncthreads per stage order the products.
//   - The product runs in true f32: explicit __fmaf_rn, no tensor cores
//     (TF32 keeps ~3 decimal digits and would break the 1e-6 bar).
//   - The file is compiled with -fmad=false so that the compensated lines
//     (Kahan carries, two-word h*b and stream folding) round each operation
//     as written; never build it with fast-math.
//   - The row outer products of the adjoint read the stored stage state
//     with a padded row stride (db + 1), so a warp's loads fall in distinct
//     shared-memory banks.
// This is the simple, correct first form: it uses one SM per run.  Splitting
// each stage's products over many blocks (cooperative launch, grid sync per
// stage) is the next step for speed.
//
// The kron pairs (K3).  The XY flip-flop terms sum_k z_k (R_k (x) C_k) + h.c.
// add to -iH u, per term, T1 = R u C^T + R^T u C and T2 = R u C^T - R^T u C:
//   h_re += za T1(x) - zb T2(y),  h_im += za T1(y) + zb T2(x),
// added term by term after the side and diagonal terms, as the Pallas code
// adds them.  Each term is 8 real products (R u, R^T u, then times C^T or C,
// for x and y): at 12 atoms XY (da = db = 64, K = 8) 8 x 8 x 64^3 FMAs = 33.6
// MFLOP a stage on top of the 4.2 MFLOP of the sides, ~23 GFLOP for K1's
// ~600 stages (~0.34 ms at 67 TFLOP/s).  K2 adds per stage the za/zb stream
// cotangents (from the transpose's own products) and 16 products per term
// and state for the part-matrix cotangents krbar / kcbar (B1 C u^T ...),
// ~108 GFLOP over the main path's 101 steps (~1.61 ms).
//   - Shared memory: the 8 (R, C) pairs alone are 256 KB at 12 atoms, more
//     than a block has, beside the 96 KB K1 already keeps there.  So R_k, C_k
//     are read from global memory (L2-resident) one term at a time, and
//     every intermediate (R u, the four products per term, the cotangent
//     fields and their products) lives in global scratch; shared memory
//     holds only the 2K stream values za, zb of the stage.
//   - Each product is a block-wide pass of register tiles (4 x 2 outputs a
//     thread), every k-sum in order from k = 0 with one rounding per FMA, so
//     the checkpointed K4 (fused_ckpt.cu) reproduces K1's states bit for bit.
//   - krbar / kcbar are accumulated in the output buffers across all steps:
//     each element belongs to one thread tile, in a fixed order (steps and
//     stages reversed, states in order), no float atomics.
//   - K = 0 takes exactly the ising path: no extra phase, no extra rounding,
//     and its own template instantiation (KRON = false), so the kron code
//     adds no register pressure to it.

#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_S 7
#define MAX_P 8  // row / column parts per side (a global channel needs 2)
#define MAX_K 32  // kron pairs (12 atoms XY: 8; an SLM-masked 16-atom XY sequence: 20)
#define NTHREADS 512
#define NWARPS (NTHREADS / 32)
#define TI 4  // rows of a thread's output tile
#define TJ 2  // columns of a thread's output tile

struct Tab {
    int S;
    float a[MAX_S][MAX_S];
    int bnz[MAX_S];  // 1 where the update weight b_s is nonzero
};

struct Geo {
    int R, n_steps, nb, da, db, pr, pc, n_eval, last_slot;
};

// forward-node streams: row hi re/im, row lo re/im, col hi re/im, col lo re/im,
// each (R, n_steps, S, P)
struct FwdStreams {
    const float* z[8];
};

// mirror-node (1 - c) streams, hi word only: row re/im, col re/im
struct MirStreams {
    const float* z[4];
};

struct Parts {
    const float* rsym;   // (pr, da, da) P + P^T
    const float* rasym;  // (pr, da, da) P - P^T
    const float* csym;   // (pc, db, db)
    const float* casym;  // (pc, db, db)
};

// the kron pairs (K = 0: none, every pointer unused)
struct Kron {
    const float* kr;     // (R, K, da, da)
    const float* kc;     // (R, K, db, db)
    const float* zf[4];  // forward-node streams (R, n_steps, S, K): hi re, hi im, lo re, lo im
    const float* zb[2];  // mirror-node streams, hi word only: re, im (K2)
    float* krbar;        // (R, K, da, da) part-matrix cotangents (K2)
    float* kcbar;        // (R, K, db, db)
    float* scratch;      // per run: products 8 K N (K2: + cotangent work 12 K N)
    int K;
};

// shared-memory view of one stage: side matrices + stage input / cotangent
struct Smem {
    float *hre, *him, *gre, *gim;  // Hrow re/im (da, da); Hcol^T re/im (db, db)
    float *ux, *uy;                // (nb, da, db + 1)
    float* zk;                     // kron stream values za (K), then zb (K)
    float* red;                    // (NWARPS, nrow) reduction partials
};

__device__ __forceinline__ Smem carve(float* sm, const Geo& g, int harea, int K) {
    Smem s;
    s.hre = sm;
    s.him = s.hre + g.da * g.da;
    s.gre = s.him + g.da * g.da;
    s.gim = s.gre + g.db * g.db;
    s.ux = sm + harea;
    s.uy = s.ux + g.nb * g.da * (g.db + 1);
    s.zk = s.uy + g.nb * g.da * (g.db + 1);
    s.red = s.zk + 2 * K;
    return s;
}

// Hrow = sum_p z_re[p] Sym_p + i sum_p z_im[p] Asym_p (hi word, then lo word
// folded in before the final rounding); Hcol likewise, stored as H^T:
// gre = re, gim = -im.  mirror: hi word of the mirror streams only.
__device__ void assemble(const Smem& sh, const Parts& pt, const float* const* z,
                         bool two_word, const Geo& g, int S, int r, int k, int s) {
    const int da2 = g.da * g.da, db2 = g.db * g.db;
    const size_t br = (((size_t)r * g.n_steps + k) * S + s) * g.pr;
    const size_t bc = (((size_t)r * g.n_steps + k) * S + s) * g.pc;
    // stream word pointers: two-word order (hi re, hi im, lo re, lo im) per side
    const float *rh_re, *rh_im, *rl_re = 0, *rl_im = 0, *ch_re, *ch_im, *cl_re = 0, *cl_im = 0;
    if (two_word) {
        rh_re = z[0]; rh_im = z[1]; rl_re = z[2]; rl_im = z[3];
        ch_re = z[4]; ch_im = z[5]; cl_re = z[6]; cl_im = z[7];
    } else {
        rh_re = z[0]; rh_im = z[1]; ch_re = z[2]; ch_im = z[3];
    }
    for (int idx = threadIdx.x; idx < da2; idx += blockDim.x) {
        float hr = 0.f, hi = 0.f, lr = 0.f, li = 0.f;
        for (int p = 0; p < g.pr; ++p) {
            const float sv = pt.rsym[(size_t)p * da2 + idx];
            const float av = pt.rasym[(size_t)p * da2 + idx];
            hr = hr + rh_re[br + p] * sv;
            hi = hi + rh_im[br + p] * av;
            if (two_word) {
                lr = lr + rl_re[br + p] * sv;
                li = li + rl_im[br + p] * av;
            }
        }
        sh.hre[idx] = two_word ? hr + lr : hr;
        sh.him[idx] = two_word ? hi + li : hi;
    }
    for (int idx = threadIdx.x; idx < db2; idx += blockDim.x) {
        float hr = 0.f, hi = 0.f, lr = 0.f, li = 0.f;
        for (int p = 0; p < g.pc; ++p) {
            const float sv = pt.csym[(size_t)p * db2 + idx];
            const float av = pt.casym[(size_t)p * db2 + idx];
            hr = hr + ch_re[bc + p] * sv;
            hi = hi + ch_im[bc + p] * av;
            if (two_word) {
                lr = lr + cl_re[bc + p] * sv;
                li = li + cl_im[bc + p] * av;
            }
        }
        sh.gre[idx] = two_word ? hr + lr : hr;
        sh.gim[idx] = -(two_word ? hi + li : hi);
    }
}

// The stage's kron stream values (K2's mirror reconstruction: hi word of the
// mirror streams; otherwise hi + lo, as _Refs.side folds them).
__device__ void assemble_kron(const Smem& sh, const Kron& kz, bool two_word, const Geo& g,
                              int S, int r, int k, int s) {
    const size_t base = (((size_t)r * g.n_steps + k) * S + s) * kz.K;
    for (int j = threadIdx.x; j < kz.K; j += blockDim.x) {
        if (two_word) {
            sh.zk[j] = kz.zf[0][base + j] + kz.zf[2][base + j];
            sh.zk[kz.K + j] = kz.zf[1][base + j] + kz.zf[3][base + j];
        } else {
            sh.zk[j] = kz.zb[0][base + j];
            sh.zk[kz.K + j] = kz.zb[1][base + j];
        }
    }
}

// Thread tiles of an (m, n) output: a thread owns rows ti*TI .. ti*TI+TI-1
// and columns tj + c*js (c < TJ, js = ceil(n / TJ)), so the lanes of a warp
// take consecutive columns of the same rows: their row-operand loads are
// broadcasts and their column-operand loads hit distinct banks.  Each
// operand loaded from shared memory then feeds TI or TJ products.
struct Tiles {
    int js, tm, count;
};

__device__ __forceinline__ Tiles tiles(int m, int n, int nb) {
    Tiles t;
    t.js = (n + TJ - 1) / TJ;
    t.tm = (m + TI - 1) / TI;
    t.count = nb * t.tm * t.js;
    return t;
}

// A real matrix read in place: X(i, k) at p[i * rs + k * cs] (shared or
// global memory; a transpose swaps the strides).
struct Mat {
    const float* p;
    int rs, cs;
};

// acc = A B over one thread tile (rows ii, columns jj), each sum over k in
// order from k = 0 with one rounding per FMA.
__device__ __forceinline__ void tile_mm(const Mat& A, const Mat& B, int kd, const int (&ii)[TI],
                                        const int (&jj)[TJ], float (&acc)[TI][TJ]) {
#pragma unroll
    for (int r = 0; r < TI; ++r)
#pragma unroll
        for (int c = 0; c < TJ; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < kd; ++k) {
        float av[TI], bv[TJ];
#pragma unroll
        for (int r = 0; r < TI; ++r) av[r] = A.p[(size_t)ii[r] * A.rs + (size_t)k * A.cs];
#pragma unroll
        for (int c = 0; c < TJ; ++c) bv[c] = B.p[(size_t)k * B.rs + (size_t)jj[c] * B.cs];
#pragma unroll
        for (int r = 0; r < TI; ++r)
#pragma unroll
            for (int c = 0; c < TJ; ++c) acc[r][c] = __fmaf_rn(av[r], bv[c], acc[r][c]);
    }
}

// The rows and columns of thread tile t of an (m, n) output (clamped at the
// ragged edge; the writer masks).
__device__ __forceinline__ void tile_at(const Tiles& tl, int t, int m, int n, int (&ii)[TI],
                                        int (&jj)[TJ]) {
    const int tj = t % tl.js, ti = t / tl.js;
#pragma unroll
    for (int r = 0; r < TI; ++r) ii[r] = min(ti * TI + r, m - 1);
#pragma unroll
    for (int c = 0; c < TJ; ++c) jj[c] = min(tj + c * tl.js, n - 1);
}

// out (m, n, row stride ldo) = A B for thread tile t.
__device__ __forceinline__ void tile_store(const Mat& A, const Mat& B, int m, int n, int kd,
                                           const Tiles& tl, int t, float* out, int ldo) {
    int ii[TI], jj[TJ];
    tile_at(tl, t, m, n, ii, jj);
    float acc[TI][TJ];
    tile_mm(A, B, kd, ii, jj, acc);
    const int ti = t / tl.js, tj = t % tl.js;
#pragma unroll
    for (int r = 0; r < TI; ++r)
#pragma unroll
        for (int c = 0; c < TJ; ++c) {
            const int i = ti * TI + r, j = tj + c * tl.js;
            if (i < m && j < n) out[(size_t)i * ldo + j] = acc[r][c];
        }
}

// The kron products of the stage vector u (sh.ux / sh.uy) into the run's
// kron scratch, per term j and state b (N = nb * da * db per block):
//   level 1  T[j][q]  = R_j u_x, R_j^T u_x, R_j u_y, R_j^T u_y   (q = 0..3)
//   level 2  KP[j][q] = T[j][0] C_j^T, T[j][1] C_j, T[j][2] C_j^T, T[j][3] C_j
// so KP holds x1 = R x C^T, x2 = R^T x C, y1, y2 of each term, as
// _Side._kron_products forms them (R first).  Ends with a block barrier.
__device__ void kron_products(const Smem& sh, const Kron& kz, const Geo& g, int r) {
    const int da = g.da, db = g.db, nb = g.nb, ldu = db + 1, K = kz.K;
    const size_t M = (size_t)da * db, N = nb * M;
    const float* kr = kz.kr + (size_t)r * K * da * da;
    const float* kc = kz.kc + (size_t)r * K * db * db;
    float* T = kz.scratch;
    float* KP = T + (size_t)4 * K * N;
    const Tiles tl = tiles(da, db, 1);
    const int jobs = 4 * K * nb;
    for (int t = threadIdx.x; t < jobs * tl.count; t += blockDim.x) {
        const int job = t / tl.count, q = (job / nb) % 4, j = job / (4 * nb), b = job % nb;
        const float* R = kr + (size_t)j * da * da;
        const Mat A = (q & 1) ? Mat{R, 1, da} : Mat{R, da, 1};
        const Mat B = {(q < 2 ? sh.ux : sh.uy) + (size_t)b * da * ldu, ldu, 1};
        tile_store(A, B, da, db, da, tl, t % tl.count, T + (4 * j + q) * N + b * M, db);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < jobs * tl.count; t += blockDim.x) {
        const int job = t / tl.count, q = (job / nb) % 4, j = job / (4 * nb), b = job % nb;
        const float* C = kc + (size_t)j * db * db;
        const Mat A = {T + (4 * j + q) * N + b * M, db, 1};
        const Mat B = (q & 1) ? Mat{C, db, 1} : Mat{C, 1, db};
        tile_store(A, B, da, db, db, tl, t % tl.count, KP + (4 * j + q) * N + b * M, db);
    }
    __syncthreads();
}

// K = sign * (-i H u) for the whole state batch, u in shared memory:
//   h_re = (Hre u_x - Him u_y) + (u_x Gre - u_y Gim) + d u_x + dlo u_x
//   h_im = (Him u_x + Hre u_y) + (u_x Gim + u_y Gre) + d u_y + dlo u_y
//   -i H u = (h_im, -h_re)
// then, term by term, the kron pairs from their products KP (kron_products):
//   h_re += za T1(x) - zb T2(y),  h_im += za T1(y) + zb T2(x).
// The real map F = -iH is antisymmetric (H hermitian, kron terms included),
// so F^T = -F: the adjoint's transpose products take sign = -1.  Every sum
// runs over k in order with one rounding per product-add, as the plain
// version does.  KRON = false compiles the ising kernels without the kron
// code (their registers, spills and arithmetic stay as without kron pairs).
template <bool KRON>
__device__ void apply_block(const Smem& sh, const Geo& g, const float* dg, const float* dl,
                            float* kx, float* ky, float sign, const Kron& kz) {
    const int da = g.da, db = g.db, ldu = db + 1, M = da * db;
    const size_t N = (size_t)g.nb * M;
    const float* KP = kz.scratch + (size_t)4 * kz.K * N;
    const Tiles tl = tiles(da, db, g.nb);
    for (int t = threadIdx.x; t < tl.count; t += blockDim.x) {
        const int tj = t % tl.js, ti = (t / tl.js) % tl.tm, b = t / (tl.js * tl.tm);
        const float* xb = sh.ux + (size_t)b * da * ldu;
        const float* yb = sh.uy + (size_t)b * da * ldu;
        int ii[TI], jj[TJ];
#pragma unroll
        for (int r = 0; r < TI; ++r) ii[r] = min(ti * TI + r, da - 1);
#pragma unroll
        for (int c = 0; c < TJ; ++c) jj[c] = min(tj + c * tl.js, db - 1);
        // row side: ra = Hre x - Him y, rb = Him x + Hre y
        float ra[TI][TJ], rb[TI][TJ];
        {
            float a1[TI][TJ] = {}, a2[TI][TJ] = {}, a3[TI][TJ] = {}, a4[TI][TJ] = {};
            for (int k = 0; k < da; ++k) {
                float hr[TI], hm[TI], xv[TJ], yv[TJ];
#pragma unroll
                for (int r = 0; r < TI; ++r) {
                    hr[r] = sh.hre[ii[r] * da + k];
                    hm[r] = sh.him[ii[r] * da + k];
                }
#pragma unroll
                for (int c = 0; c < TJ; ++c) {
                    xv[c] = xb[k * ldu + jj[c]];
                    yv[c] = yb[k * ldu + jj[c]];
                }
#pragma unroll
                for (int r = 0; r < TI; ++r) {
#pragma unroll
                    for (int c = 0; c < TJ; ++c) {
                        a1[r][c] = __fmaf_rn(hr[r], xv[c], a1[r][c]);
                        a2[r][c] = __fmaf_rn(hm[r], yv[c], a2[r][c]);
                        a3[r][c] = __fmaf_rn(hm[r], xv[c], a3[r][c]);
                        a4[r][c] = __fmaf_rn(hr[r], yv[c], a4[r][c]);
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < TI; ++r) {
#pragma unroll
                for (int c = 0; c < TJ; ++c) {
                    ra[r][c] = a1[r][c] - a2[r][c];
                    rb[r][c] = a3[r][c] + a4[r][c];
                }
            }
        }
        // column side: x Gre - y Gim and x Gim + y Gre
        float c1[TI][TJ] = {}, c2[TI][TJ] = {}, c3[TI][TJ] = {}, c4[TI][TJ] = {};
        for (int k = 0; k < db; ++k) {
            float xr[TI], yr[TI], gr[TJ], gm[TJ];
#pragma unroll
            for (int r = 0; r < TI; ++r) {
                xr[r] = xb[ii[r] * ldu + k];
                yr[r] = yb[ii[r] * ldu + k];
            }
#pragma unroll
            for (int c = 0; c < TJ; ++c) {
                gr[c] = sh.gre[k * db + jj[c]];
                gm[c] = sh.gim[k * db + jj[c]];
            }
#pragma unroll
            for (int r = 0; r < TI; ++r) {
#pragma unroll
                for (int c = 0; c < TJ; ++c) {
                    c1[r][c] = __fmaf_rn(xr[r], gr[c], c1[r][c]);
                    c2[r][c] = __fmaf_rn(yr[r], gm[c], c2[r][c]);
                    c3[r][c] = __fmaf_rn(xr[r], gm[c], c3[r][c]);
                    c4[r][c] = __fmaf_rn(yr[r], gr[c], c4[r][c]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < TI; ++r) {
#pragma unroll
            for (int c = 0; c < TJ; ++c) {
                const int i = ti * TI + r, j = tj + c * tl.js;
                if (i >= da || j >= db) continue;
                const int m = i * db + j;
                const float x = xb[i * ldu + j], y = yb[i * ldu + j];
                float h_re = ((ra[r][c] + (c1[r][c] - c2[r][c])) + dg[m] * x) + dl[m] * x;
                float h_im = ((rb[r][c] + (c3[r][c] + c4[r][c])) + dg[m] * y) + dl[m] * y;
                const size_t e = (size_t)b * M + m;
                if constexpr (KRON) {
                    for (int q = 0; q < kz.K; ++q) {
                        const float* P = KP + (size_t)4 * q * N + e;
                        const float x1 = P[0], x2 = P[N], y1 = P[2 * N], y2 = P[3 * N];
                        const float za = sh.zk[q], zb = sh.zk[kz.K + q];
                        h_re = h_re + (za * (x1 + x2) - zb * (y1 - y2));
                        h_im = h_im + (za * (y1 + y2) + zb * (x1 - x2));
                    }
                }
                kx[e] = sign * h_im;
                ky[e] = -sign * h_re;
            }
        }
    }
}

__device__ __forceinline__ int uidx(const Geo& g, int e) {
    const int M = g.da * g.db;
    const int b = e / M, rem = e - b * M;
    const int i = rem / g.db, j = rem - i * g.db;
    return (b * g.da + i) * (g.db + 1) + j;
}

// ---------------------------------------------------------------------------
// K1: forward evolution writing every evaluation-slot state
// ---------------------------------------------------------------------------
template <bool KRON>
__global__ void __launch_bounds__(NTHREADS)
fused_fwd_kernel(const float* __restrict__ psi_re, const float* __restrict__ psi_im,
                 Parts pt, FwdStreams zf,
                 const float* __restrict__ hb_hi, const float* __restrict__ hb_lo,
                 const float* __restrict__ hs,
                 const float* __restrict__ diag, const float* __restrict__ diag_lo,
                 const int* __restrict__ slots,
                 float* __restrict__ out_re, float* __restrict__ out_im,
                 float* __restrict__ lo_re, float* __restrict__ lo_im,
                 float* __restrict__ scratch, Kron kz, Geo g, Tab tab, int harea) {
    extern __shared__ float sm[];
    const Smem sh = carve(sm, g, harea, kz.K);
    const int r = blockIdx.x, S = tab.S;
    const int M = g.da * g.db, N = g.nb * M;
    kz.scratch += (size_t)r * 8 * kz.K * N;  // this run's kron products
    float* X = scratch + (size_t)r * (4 + 2 * S) * N;
    float* Y = X + N;
    float* CX = Y + N;
    float* CY = CX + N;
    float* K = CY + N;  // stage s: x at K + 2sN, y at K + 2sN + N
    const float* dg = diag + (size_t)r * M;
    const float* dl = diag_lo + (size_t)r * M;
    float* ore = out_re + (size_t)r * g.n_eval * N;
    float* oim = out_im + (size_t)r * g.n_eval * N;
    // the slot states' low words (the negated Kahan carries), when asked for
    float* lre = lo_re ? lo_re + (size_t)r * g.n_eval * N : 0;
    float* lim = lo_im ? lo_im + (size_t)r * g.n_eval * N : 0;

    const int slot0 = slots[0];
    for (int e = threadIdx.x; e < N; e += blockDim.x) {
        const float x = psi_re[(size_t)r * N + e], y = psi_im[(size_t)r * N + e];
        X[e] = x; Y[e] = y; CX[e] = 0.f; CY[e] = 0.f;
        if (slot0 < g.n_eval) { ore[(size_t)slot0 * N + e] = x; oim[(size_t)slot0 * N + e] = y; }
        if (slot0 < g.n_eval && lre) {
            lre[(size_t)slot0 * N + e] = 0.f;
            lim[(size_t)slot0 * N + e] = 0.f;
        }
    }
    for (int k = 0; k < g.n_steps; ++k) {
        const float h = hs[k];
        for (int s = 0; s < S; ++s) {
            for (int e = threadIdx.x; e < N; e += blockDim.x) {
                float xs = X[e], ys = Y[e];
                for (int j = 0; j < s; ++j) {
                    const float a = tab.a[s][j];
                    if (a != 0.f) {
                        const float c = a * h;
                        xs = xs + c * K[(size_t)2 * j * N + e];
                        ys = ys + c * K[(size_t)2 * j * N + N + e];
                    }
                }
                const int u = uidx(g, e);
                sh.ux[u] = xs; sh.uy[u] = ys;
            }
            assemble(sh, pt, zf.z, true, g, S, r, k, s);
            if constexpr (KRON) assemble_kron(sh, kz, true, g, S, r, k, s);
            __syncthreads();
            if constexpr (KRON) kron_products(sh, kz, g, r);
            apply_block<KRON>(sh, g, dg, dl, K + (size_t)2 * s * N, K + (size_t)2 * s * N + N, 1.f,
                              kz);
            __syncthreads();
        }
        // two-word h*b_s increment (hi words, then lo words), Kahan update
        const int slot = slots[k + 1];
        for (int e = threadIdx.x; e < N; e += blockDim.x) {
            float dx = 0.f, dy = 0.f;
            bool first = true;
            for (int s = 0; s < S; ++s) {
                if (!tab.bnz[s]) continue;
                const float w = hb_hi[k * S + s];
                const float kx = K[(size_t)2 * s * N + e], ky = K[(size_t)2 * s * N + N + e];
                if (first) { dx = w * kx; dy = w * ky; first = false; }
                else { dx = dx + w * kx; dy = dy + w * ky; }
            }
            for (int s = 0; s < S; ++s) {
                if (!tab.bnz[s]) continue;
                const float w = hb_lo[k * S + s];
                dx = dx + w * K[(size_t)2 * s * N + e];
                dy = dy + w * K[(size_t)2 * s * N + N + e];
            }
            float x = X[e], cx = CX[e];
            float yk = dx - cx, t = x + yk;
            cx = (t - x) - yk; CX[e] = cx; X[e] = t; x = t;
            float y = Y[e], cy = CY[e];
            yk = dy - cy; t = y + yk;
            cy = (t - y) - yk; CY[e] = cy; Y[e] = t; y = t;
            if (slot < g.n_eval) { ore[(size_t)slot * N + e] = x; oim[(size_t)slot * N + e] = y; }
            if (slot < g.n_eval && lre) {
                lre[(size_t)slot * N + e] = -cx;
                lim[(size_t)slot * N + e] = -cy;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// K2: discrete adjoint over the steps in reverse (lean interval form)
// ---------------------------------------------------------------------------
// Block-wide sums of the per-thread cotangent partials into out[0 .. nrow):
// the parts' (2 pr + 2 pc), then each kron pair's (za_bar, zb_bar) of the
// stage cotangent g against the stage input u (us: (2, nb, da, db), global),
// from the products of g that the transpose application left in the kron
// scratch:  za_bar = <g_x, T1(u_y)> - <g_y, T1(u_x)> = <T1(g_x), u_y> - <T1(g_y), u_x>,
//           zb_bar = <g_x, T2(u_x)> + <g_y, T2(u_y)> = -<T2(g_x), u_x> - <T2(g_y), u_y>
// (T1 is self-adjoint, T2 anti-self-adjoint).  The Pallas _kron_cotangents
// gives zb_bar the opposite sign; no XY gradient reaches it (the kron
// streams are constants), and the port takes the derivative's sign.
template <bool KRON>
__device__ __forceinline__ void reduce_rows(const Smem& sh, const float* acc_r, const float* acc_c,
                                            const Geo& g, const Kron& kz, const float* us,
                                            float* out) {
    const int nrow = 2 * g.pr + 2 * g.pc + 2 * kz.K;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    const size_t N = (size_t)g.nb * g.da * g.db;
    const float* KP = kz.scratch + (size_t)4 * kz.K * N;
    for (int q = 0; KRON && q < kz.K; ++q) {
        float va = 0.f, vb = 0.f;
        for (size_t e = threadIdx.x; e < N; e += blockDim.x) {
            const float* P = KP + (size_t)4 * q * N + e;
            const float x1 = P[0], x2 = P[N], y1 = P[2 * N], y2 = P[3 * N];
            const float ux = us[e], uy = us[N + e];
            va = va + ((x1 + x2) * uy - (y1 + y2) * ux);
            vb = vb + ((x2 - x1) * ux + (y2 - y1) * uy);
        }
        for (int off = 16; off > 0; off >>= 1) {
            va += __shfl_down_sync(0xffffffffu, va, off);
            vb += __shfl_down_sync(0xffffffffu, vb, off);
        }
        if (lane == 0) {
            sh.red[warp * nrow + 2 * g.pr + 2 * g.pc + 2 * q] = va;
            sh.red[warp * nrow + 2 * g.pr + 2 * g.pc + 2 * q + 1] = vb;
        }
    }
#pragma unroll
    for (int q = 0; q < 2 * MAX_P; ++q) {
        if (q < 2 * g.pr) {
            float v = acc_r[q];
            for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
            if (lane == 0) sh.red[warp * nrow + q] = v;
        }
    }
#pragma unroll
    for (int q = 0; q < 2 * MAX_P; ++q) {
        if (q < 2 * g.pc) {
            float v = acc_c[q];
            for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
            if (lane == 0) sh.red[warp * nrow + 2 * g.pr + q] = v;
        }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < nrow; q += blockDim.x) {
        float v = 0.f;
        for (int w = 0; w < nwarps; ++w) v += sh.red[w * nrow + q];
        out[q] = v;
    }
}

// The stream cotangents of one stage, g the stage cotangent (sh.ux/uy)
// and u the stage input (usx/usy), both (nb, da, db + 1) in shared memory:
//   row side  W  = sum_b g_x u_y^T - g_y u_x^T,  V  = sum_b g_x u_x^T + g_y u_y^T  (da, da)
//   col side  Wc = sum_b u_y^T g_x - u_x^T g_y,  Vc = sum_b u_x^T g_x + u_y^T g_y  (db, db)
//   out = (<Sym_p, W>, <Asym_p, V>)_p, then (<Sym_p, Wc>, -<Asym_p, Vc>)_p
// (the column side is stored transposed, and P^T - P = -Asym).
template <bool KRON>
__device__ void stage_cotangents(const Smem& sh, const float* usx, const float* usy,
                                 const Parts& pt, const Geo& g, const Kron& kz, const float* us,
                                 float* out) {
    const int da = g.da, db = g.db, nb = g.nb, ldu = db + 1;
    float acc_r[2 * MAX_P] = {}, acc_c[2 * MAX_P] = {};
    const Tiles tr = tiles(da, da, 1);
    for (int t = threadIdx.x; t < tr.count; t += blockDim.x) {
        const int tj = t % tr.js, ti = t / tr.js;
        int ii[TI], jj[TJ];
#pragma unroll
        for (int r = 0; r < TI; ++r) ii[r] = min(ti * TI + r, da - 1);
#pragma unroll
        for (int c = 0; c < TJ; ++c) jj[c] = min(tj + c * tr.js, da - 1);
        float w[TI][TJ] = {}, v[TI][TJ] = {};
        for (int b = 0; b < nb; ++b) {
            float w1[TI][TJ] = {}, w2[TI][TJ] = {}, v1[TI][TJ] = {}, v2[TI][TJ] = {};
            for (int kk = 0; kk < db; ++kk) {
                float gx[TI], gy[TI], ux[TJ], uy[TJ];
#pragma unroll
                for (int r = 0; r < TI; ++r) {
                    gx[r] = sh.ux[(size_t)(b * da + ii[r]) * ldu + kk];
                    gy[r] = sh.uy[(size_t)(b * da + ii[r]) * ldu + kk];
                }
#pragma unroll
                for (int c = 0; c < TJ; ++c) {
                    ux[c] = usx[(size_t)(b * da + jj[c]) * ldu + kk];
                    uy[c] = usy[(size_t)(b * da + jj[c]) * ldu + kk];
                }
#pragma unroll
                for (int r = 0; r < TI; ++r) {
#pragma unroll
                    for (int c = 0; c < TJ; ++c) {
                        w1[r][c] = __fmaf_rn(gx[r], uy[c], w1[r][c]);
                        w2[r][c] = __fmaf_rn(gy[r], ux[c], w2[r][c]);
                        v1[r][c] = __fmaf_rn(gx[r], ux[c], v1[r][c]);
                        v2[r][c] = __fmaf_rn(gy[r], uy[c], v2[r][c]);
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < TI; ++r) {
#pragma unroll
                for (int c = 0; c < TJ; ++c) {
                    w[r][c] = w[r][c] + (w1[r][c] - w2[r][c]);
                    v[r][c] = v[r][c] + (v1[r][c] + v2[r][c]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < TI; ++r) {
#pragma unroll
            for (int c = 0; c < TJ; ++c) {
                const int i = ti * TI + r, j = tj + c * tr.js;
                if (i >= da || j >= da) continue;
                const size_t q = (size_t)i * da + j;
#pragma unroll
                for (int p = 0; p < MAX_P; ++p) {
                    if (p < g.pr) {
                        acc_r[2 * p] = acc_r[2 * p] + pt.rsym[(size_t)p * da * da + q] * w[r][c];
                        acc_r[2 * p + 1] = acc_r[2 * p + 1] + pt.rasym[(size_t)p * da * da + q] * v[r][c];
                    }
                }
            }
        }
    }
    const Tiles tc = tiles(db, db, 1);
    for (int t = threadIdx.x; t < tc.count; t += blockDim.x) {
        const int tj = t % tc.js, ti = t / tc.js;
        int ii[TI], jj[TJ];
#pragma unroll
        for (int r = 0; r < TI; ++r) ii[r] = min(ti * TI + r, db - 1);
#pragma unroll
        for (int c = 0; c < TJ; ++c) jj[c] = min(tj + c * tc.js, db - 1);
        float w[TI][TJ] = {}, v[TI][TJ] = {};
        for (int b = 0; b < nb; ++b) {
            float w1[TI][TJ] = {}, w2[TI][TJ] = {}, v1[TI][TJ] = {}, v2[TI][TJ] = {};
            for (int kk = 0; kk < da; ++kk) {
                const size_t row = (size_t)(b * da + kk) * ldu;
                float ux[TI], uy[TI], gx[TJ], gy[TJ];
#pragma unroll
                for (int r = 0; r < TI; ++r) {
                    ux[r] = usx[row + ii[r]];
                    uy[r] = usy[row + ii[r]];
                }
#pragma unroll
                for (int c = 0; c < TJ; ++c) {
                    gx[c] = sh.ux[row + jj[c]];
                    gy[c] = sh.uy[row + jj[c]];
                }
#pragma unroll
                for (int r = 0; r < TI; ++r) {
#pragma unroll
                    for (int c = 0; c < TJ; ++c) {
                        w1[r][c] = __fmaf_rn(uy[r], gx[c], w1[r][c]);
                        w2[r][c] = __fmaf_rn(ux[r], gy[c], w2[r][c]);
                        v1[r][c] = __fmaf_rn(ux[r], gx[c], v1[r][c]);
                        v2[r][c] = __fmaf_rn(uy[r], gy[c], v2[r][c]);
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < TI; ++r) {
#pragma unroll
                for (int c = 0; c < TJ; ++c) {
                    w[r][c] = w[r][c] + (w1[r][c] - w2[r][c]);
                    v[r][c] = v[r][c] + (v1[r][c] + v2[r][c]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < TI; ++r) {
#pragma unroll
            for (int c = 0; c < TJ; ++c) {
                const int i = ti * TI + r, j = tj + c * tc.js;
                if (i >= db || j >= db) continue;
                const size_t q = (size_t)i * db + j;
#pragma unroll
                for (int p = 0; p < MAX_P; ++p) {
                    if (p < g.pc) {
                        acc_c[2 * p] = acc_c[2 * p] + pt.csym[(size_t)p * db * db + q] * w[r][c];
                        acc_c[2 * p + 1] = acc_c[2 * p + 1] - pt.casym[(size_t)p * db * db + q] * v[r][c];
                    }
                }
            }
        }
    }
    reduce_rows<KRON>(sh, acc_r, acc_c, g, kz, us, out);
}

// The part-matrix cotangents of one stage (_kron_matrix_cotangents), from
// the stage cotangent g (sh.ux / sh.uy, padded) and the stage input u (us,
// global).  Per term j and state b, with the coefficient fields
//   B1 = zb gx - za gy,  B2 = -zb gx - za gy,  D1 = za gx + zb gy,  D2 = za gx - zb gy,
//   krbar_j += B1 C ux^T + (ux C) B2^T + D1 C uy^T + (uy C) D2^T
//   kcbar_j += B1^T (R ux) + ux^T (R B2) + D1^T (R uy) + uy^T (R D2)
// added in that order, state after state.  Work lives in the run's kron
// scratch after the products: the fields F (4 K N), then the level-1
// products P (8 K N).  Ends with a block barrier.
__device__ void kron_matrix_cotangents(const Smem& sh, const Kron& kz, const Geo& g, int r,
                                       const float* us) {
    const int da = g.da, db = g.db, nb = g.nb, K = kz.K;
    const size_t M = (size_t)da * db, N = nb * M;
    const float* kr = kz.kr + (size_t)r * K * da * da;
    const float* kc = kz.kc + (size_t)r * K * db * db;
    float* F = kz.scratch + (size_t)8 * K * N;
    float* P = F + (size_t)4 * K * N;
    for (size_t e = threadIdx.x; e < N; e += blockDim.x) {
        const int u = uidx(g, (int)e);
        const float gx = sh.ux[u], gy = sh.uy[u];
        for (int j = 0; j < K; ++j) {
            const float za = sh.zk[j], zb = sh.zk[K + j];
            float* f = F + (size_t)4 * j * N + e;
            f[0] = zb * gx - za * gy;
            f[N] = -zb * gx - za * gy;
            f[2 * N] = za * gx + zb * gy;
            f[3 * N] = za * gx - zb * gy;
        }
    }
    __syncthreads();
    // level 1: B1 C, ux C, D1 C, uy C (q = 0..3), R ux, R B2, R uy, R D2 (q = 4..7)
    const Tiles tl = tiles(da, db, 1);
    const int jobs = 8 * K * nb;
    for (int t = threadIdx.x; t < jobs * tl.count; t += blockDim.x) {
        const int job = t / tl.count, q = (job / nb) % 8, j = job / (8 * nb), b = job % nb;
        const float* f = F + (size_t)4 * j * N + b * M;
        const float* ub = us + b * M;
        // the left (q < 4) or right (q >= 4) operand: B1, ux, D1, uy / ux, B2, uy, D2
        const float* opnd[8] = {f, ub, f + 2 * N, ub + N, ub, f + N, ub + N, f + 3 * N};
        const Mat X = {opnd[q], db, 1};
        float* out = P + (8 * j + q) * N + b * M;
        if (q < 4) {
            const Mat C = {kc + (size_t)j * db * db, db, 1};
            tile_store(X, C, da, db, db, tl, t % tl.count, out, db);
        } else {
            const Mat R = {kr + (size_t)j * da * da, da, 1};
            tile_store(R, X, da, db, da, tl, t % tl.count, out, db);
        }
    }
    __syncthreads();
    // level 2, accumulated into the outputs
    const Tiles tr = tiles(da, da, 1), tc = tiles(db, db, 1);
    for (int t = threadIdx.x; t < K * (tr.count + tc.count); t += blockDim.x) {
        const int j = t / (tr.count + tc.count);
        int tt = t % (tr.count + tc.count);
        const bool row = tt < tr.count;
        if (!row) tt -= tr.count;
        const int n = row ? da : db;
        const Tiles& tl2 = row ? tr : tc;
        int ii[TI], jj[TJ];
        tile_at(tl2, tt, n, n, ii, jj);
        float* dst = row ? kz.krbar + ((size_t)r * K + j) * da * da
                         : kz.kcbar + ((size_t)r * K + j) * db * db;
        float acc[TI][TJ];
        const int ti = tt / tl2.js, tj = tt % tl2.js;
#pragma unroll
        for (int a = 0; a < TI; ++a)
#pragma unroll
            for (int c = 0; c < TJ; ++c) acc[a][c] = dst[(size_t)ii[a] * n + jj[c]];
        for (int b = 0; b < nb; ++b) {
            const float* f = F + (size_t)4 * j * N + b * M;
            const float* ub = us + b * M;
            const float* p = P + (size_t)8 * j * N + b * M;
            // (left, right) operands of the four products, in order
            Mat L[4], Rt[4];
            int kd;
            if (row) {  // (da, db) x (db, da): P_q times ux^T, B2^T, uy^T, D2^T
                const float* rhs[4] = {ub, f + N, ub + N, f + 3 * N};
                for (int q = 0; q < 4; ++q) {
                    L[q] = Mat{p + q * N, db, 1};
                    Rt[q] = Mat{rhs[q], 1, db};
                }
                kd = db;
            } else {  // (db, da) x (da, db): B1^T, ux^T, D1^T, uy^T times P_{4+q}
                const float* lhs[4] = {f, ub, f + 2 * N, ub + N};
                for (int q = 0; q < 4; ++q) {
                    L[q] = Mat{lhs[q], 1, db};
                    Rt[q] = Mat{p + (4 + q) * N, db, 1};
                }
                kd = da;
            }
            for (int q = 0; q < 4; ++q) {
                float tq[TI][TJ];
                tile_mm(L[q], Rt[q], kd, ii, jj, tq);
#pragma unroll
                for (int a = 0; a < TI; ++a)
#pragma unroll
                    for (int c = 0; c < TJ; ++c) acc[a][c] = acc[a][c] + tq[a][c];
            }
        }
#pragma unroll
        for (int a = 0; a < TI; ++a)
#pragma unroll
            for (int c = 0; c < TJ; ++c) {
                const int i = ti * TI + a, jc = tj + c * tl2.js;
                if (i < n && jc < n) dst[(size_t)i * n + jc] = acc[a][c];
            }
    }
    __syncthreads();
}

template <bool KRON>
__global__ void __launch_bounds__(NTHREADS)
fused_bwd_kernel(const float* __restrict__ st_re, const float* __restrict__ st_im,
                 const float* __restrict__ lam_re, const float* __restrict__ lam_im,
                 Parts pt, FwdStreams zf, MirStreams zb,
                 const float* __restrict__ hb_hi, const float* __restrict__ hb_lo,
                 const float* __restrict__ hs,
                 const float* __restrict__ diag, const float* __restrict__ diag_lo,
                 const int* __restrict__ slots,
                 float* __restrict__ lam0_re, float* __restrict__ lam0_im,
                 float* __restrict__ zbar, float* __restrict__ dbar,
                 float* __restrict__ scratch, Kron kz, Geo g, Tab tab, int harea) {
    extern __shared__ float sm[];
    const Smem sh = carve(sm, g, harea, kz.K);
    const int r = blockIdx.x, S = tab.S;
    const int da = g.da, db = g.db, nb = g.nb, ldu = db + 1;
    const int M = da * db, N = nb * M;
    const int nrow = 2 * g.pr + 2 * g.pc + 2 * kz.K;
    kz.scratch += (size_t)r * 20 * kz.K * N;  // this run's kron products and cotangent work
    const size_t twoN = (size_t)2 * N;
    float* X = scratch + (size_t)r * (4 + 6 * S) * N;  // x, y
    float* L = X + twoN;                                // lx, ly
    float* RK = L + twoN;                               // mirror stages, then forward stages
    float* US = RK + S * twoN;                          // forward stage inputs
    float* WS = US + S * twoN;                          // transpose products
    const float* dg = diag + (size_t)r * M;
    const float* dl = diag_lo + (size_t)r * M;
    float* db_out = dbar + (size_t)r * M;
    const float* sre = st_re + (size_t)r * g.n_eval * N;
    const float* sim = st_im + (size_t)r * g.n_eval * N;
    const float* lre = lam_re + (size_t)r * g.n_eval * N;
    const float* lim = lam_im + (size_t)r * g.n_eval * N;
    // stage-input views in the H area for the outer products
    const float* usx_sh = sm;
    const float* usy_sh = sm + nb * da * ldu;

    for (int e = threadIdx.x; e < N; e += blockDim.x) {
        const size_t o = (size_t)g.last_slot * N + e;
        X[e] = sre[o]; X[N + e] = sim[o];
        L[e] = lre[o]; L[N + e] = lim[o];
    }
    for (int m = threadIdx.x; m < M; m += blockDim.x) db_out[m] = 0.f;
    if constexpr (KRON) {
        for (size_t m = threadIdx.x; m < (size_t)kz.K * da * da; m += blockDim.x)
            kz.krbar[(size_t)r * kz.K * da * da + m] = 0.f;
        for (size_t m = threadIdx.x; m < (size_t)kz.K * db * db; m += blockDim.x)
            kz.kcbar[(size_t)r * kz.K * db * db + m] = 0.f;
    }

    for (int it = 0; it < g.n_steps; ++it) {
        const int k = g.n_steps - 1 - it;
        const float h = hs[k];
        // 1. reconstruct the step's start state by reverse-time ERK on the mirror streams
        for (int s = 0; s < S; ++s) {
            for (int e = threadIdx.x; e < N; e += blockDim.x) {
                float xs = X[e], ys = X[N + e];
                for (int j = 0; j < s; ++j) {
                    const float a = tab.a[s][j];
                    if (a != 0.f) {
                        const float c = a * h;
                        xs = xs - c * RK[j * twoN + e];
                        ys = ys - c * RK[j * twoN + N + e];
                    }
                }
                const int u = uidx(g, e);
                sh.ux[u] = xs; sh.uy[u] = ys;
            }
            assemble(sh, pt, zb.z, false, g, S, r, k, s);
            if constexpr (KRON) assemble_kron(sh, kz, false, g, S, r, k, s);
            __syncthreads();
            if constexpr (KRON) kron_products(sh, kz, g, r);
            apply_block<KRON>(sh, g, dg, dl, RK + s * twoN, RK + s * twoN + N, 1.f, kz);
            __syncthreads();
        }
        for (int e = threadIdx.x; e < N; e += blockDim.x) {
            float x0 = X[e], y0 = X[N + e];
            for (int s = 0; s < S; ++s) {
                if (!tab.bnz[s]) continue;
                const float bhl = hb_hi[k * S + s] + hb_lo[k * S + s];
                x0 = x0 - bhl * RK[s * twoN + e];
                y0 = y0 - bhl * RK[s * twoN + N + e];
            }
            X[e] = x0; X[N + e] = y0;
        }
        // 2. recompute the forward stage inputs (the last stage's product is dead)
        for (int s = 0; s < S; ++s) {
            for (int e = threadIdx.x; e < N; e += blockDim.x) {
                float xs = X[e], ys = X[N + e];
                for (int j = 0; j < s; ++j) {
                    const float a = tab.a[s][j];
                    if (a != 0.f) {
                        const float c = a * h;
                        xs = xs + c * RK[j * twoN + e];
                        ys = ys + c * RK[j * twoN + N + e];
                    }
                }
                US[s * twoN + e] = xs; US[s * twoN + N + e] = ys;
                const int u = uidx(g, e);
                sh.ux[u] = xs; sh.uy[u] = ys;
            }
            if (s == S - 1) break;
            assemble(sh, pt, zf.z, true, g, S, r, k, s);
            if constexpr (KRON) assemble_kron(sh, kz, true, g, S, r, k, s);
            __syncthreads();
            if constexpr (KRON) kron_products(sh, kz, g, r);
            apply_block<KRON>(sh, g, dg, dl, RK + s * twoN, RK + s * twoN + N, 1.f, kz);
            __syncthreads();
        }
        __syncthreads();
        // 3. reversed transpose recursion with the cotangent work of each stage
        for (int s = S - 1; s >= 0; --s) {
            for (int e = threadIdx.x; e < N; e += blockDim.x) {
                float gx = 0.f, gy = 0.f;
                if (tab.bnz[s]) {
                    const float bhl = hb_hi[k * S + s] + hb_lo[k * S + s];
                    gx = bhl * L[e]; gy = bhl * L[N + e];
                }
                for (int rr = s + 1; rr < S; ++rr) {
                    const float a = tab.a[rr][s];
                    if (a != 0.f) {
                        const float c = a * h;
                        gx = gx + c * WS[rr * twoN + e];
                        gy = gy + c * WS[rr * twoN + N + e];
                    }
                }
                const int u = uidx(g, e);
                sh.ux[u] = gx; sh.uy[u] = gy;
            }
            assemble(sh, pt, zf.z, true, g, S, r, k, s);
            if constexpr (KRON) assemble_kron(sh, kz, true, g, S, r, k, s);
            __syncthreads();
            if constexpr (KRON) kron_products(sh, kz, g, r);
            apply_block<KRON>(sh, g, dg, dl, WS + s * twoN, WS + s * twoN + N, -1.f, kz);
            for (int m = threadIdx.x; m < M; m += blockDim.x) {
                float acc = 0.f;
                for (int b = 0; b < nb; ++b) {
                    const int u = (b * da + m / db) * ldu + m % db;
                    const size_t o = (size_t)b * M + m;
                    acc = acc + (sh.ux[u] * US[s * twoN + N + o] - sh.uy[u] * US[s * twoN + o]);
                }
                db_out[m] = db_out[m] + acc;
            }
            __syncthreads();
            // stage input u_s into the H area, padded like the cotangent
            for (int e = threadIdx.x; e < N; e += blockDim.x) {
                const int u = uidx(g, e);
                sm[u] = US[s * twoN + e];
                sm[nb * da * ldu + u] = US[s * twoN + N + e];
            }
            __syncthreads();
            stage_cotangents<KRON>(sh, usx_sh, usy_sh, pt, g, kz, US + s * twoN,
                             zbar + (((size_t)r * g.n_steps + k) * S + s) * nrow);
            __syncthreads();
            if constexpr (KRON) kron_matrix_cotangents(sh, kz, g, r, US + s * twoN);
        }
        // 4. costate update, then 5. the stored state / slot cotangent at grid point k
        const int slot = slots[k];
        for (int e = threadIdx.x; e < N; e += blockDim.x) {
            float lx = L[e], ly = L[N + e];
            for (int s = 0; s < S; ++s) {
                lx = lx + WS[s * twoN + e];
                ly = ly + WS[s * twoN + N + e];
            }
            if (slot < g.n_eval) {
                const size_t o = (size_t)slot * N + e;
                X[e] = sre[o]; X[N + e] = sim[o];
                lx = lx + lre[o]; ly = ly + lim[o];
            }
            L[e] = lx; L[N + e] = ly;
        }
        __syncthreads();
    }
    for (int e = threadIdx.x; e < N; e += blockDim.x) {
        lam0_re[(size_t)r * N + e] = L[e];
        lam0_im[(size_t)r * N + e] = L[N + e];
    }
}

// ---------------------------------------------------------------------------
// C interface (ctypes).  Every function returns 0 on success, a negative
// code for a shape the kernel does not take (-1 tableau, -2 parts, -4 kron
// pairs), or the cudaError_t of the launch.  Launches go to the caller's
// stream; nothing synchronises.
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

static int h_area(int nb, int da, int db) {
    const int hsz = 2 * da * da + 2 * db * db;
    const int usz = 2 * nb * da * (db + 1);
    return hsz > usz ? hsz : usz;
}

// shared memory: the H area, the padded stage vector, the 2K kron stream
// values and (K2) the reduction partials
extern "C" size_t pdt_fused_smem_bytes(int bwd, int nb, int da, int db, int pr, int pc, int K) {
    const size_t harea = (size_t)h_area(nb, da, db);
    const size_t usz = (size_t)2 * nb * da * (db + 1);
    const size_t red = bwd ? (size_t)NWARPS * (2 * pr + 2 * pc + 2 * K) : 0;
    return (harea + usz + 2 * (size_t)K + red) * sizeof(float);
}

// the state and stage buffers of every run, then every run's kron scratch
static size_t base_floats(int bwd, int R, int S, size_t N) {
    return (size_t)R * (bwd ? (4 + 6 * S) : (4 + 2 * S)) * N;
}

extern "C" size_t pdt_fused_scratch_floats(int bwd, int R, int S, int nb, int da, int db, int K) {
    const size_t N = (size_t)nb * da * db;
    return base_floats(bwd, R, S, N) + (size_t)R * (bwd ? 20 : 8) * K * N;
}

// kron inputs: kr, kc, the four forward-node and (K2) two mirror-node streams
static Kron make_kron(const float* const* kin, float* krbar, float* kcbar, float* kscratch, int K,
                      int bwd) {
    Kron kz = {};
    kz.K = K;
    kz.scratch = kscratch;
    if (!K) return kz;
    kz.kr = kin[0];
    kz.kc = kin[1];
    for (int i = 0; i < 4; ++i) kz.zf[i] = kin[2 + i];
    if (bwd) {
        kz.zb[0] = kin[6];
        kz.zb[1] = kin[7];
        kz.krbar = krbar;
        kz.kcbar = kcbar;
    }
    return kz;
}

extern "C" int pdt_fused_fwd(const float* psi_re, const float* psi_im,
                             const float* rsym, const float* rasym,
                             const float* csym, const float* casym,
                             const float* const* zf,
                             const float* hb_hi, const float* hb_lo, const float* hs,
                             const float* diag, const float* diag_lo, const int* slots,
                             float* out_re, float* out_im, float* lo_re, float* lo_im,
                             float* scratch, const float* const* kron_in, int K,
                             int R, int n_steps, int nb, int da, int db, int pr, int pc,
                             int n_eval, int S, const double* a, const int* bnz,
                             void* stream) {
    Tab tab;
    if (make_tab(&tab, S, a, bnz)) return -1;
    if (pr > MAX_P || pc > MAX_P) return -2;
    if (K < 0 || K > MAX_K) return -4;
    const size_t smem = pdt_fused_smem_bytes(0, nb, da, db, pr, pc, K);
    // the kron-pair branch is its own instantiation
    auto kern = K ? fused_fwd_kernel<true> : fused_fwd_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    Geo g = {R, n_steps, nb, da, db, pr, pc, n_eval, 0};
    Parts pt = {rsym, rasym, csym, casym};
    FwdStreams z;
    for (int i = 0; i < 8; ++i) z.z[i] = zf[i];
    const Kron kz = make_kron(kron_in, 0, 0,
                              scratch + base_floats(0, R, S, (size_t)nb * da * db), K, 0);
    kern<<<R, NTHREADS, smem, (cudaStream_t)stream>>>(
        psi_re, psi_im, pt, z, hb_hi, hb_lo, hs, diag, diag_lo, slots,
        out_re, out_im, lo_re, lo_im, scratch, kz, g, tab, h_area(nb, da, db));
    return (int)cudaGetLastError();
}

extern "C" int pdt_fused_bwd(const float* st_re, const float* st_im,
                             const float* lam_re, const float* lam_im,
                             const float* rsym, const float* rasym,
                             const float* csym, const float* casym,
                             const float* const* zf, const float* const* zb,
                             const float* hb_hi, const float* hb_lo, const float* hs,
                             const float* diag, const float* diag_lo, const int* slots,
                             float* lam0_re, float* lam0_im, float* zbar, float* dbar,
                             float* scratch,
                             const float* const* kron_in, float* krbar, float* kcbar, int K,
                             int R, int n_steps, int nb, int da, int db, int pr, int pc,
                             int n_eval, int last_slot, int S, const double* a, const int* bnz,
                             void* stream) {
    Tab tab;
    if (make_tab(&tab, S, a, bnz)) return -1;
    if (pr > MAX_P || pc > MAX_P) return -2;
    if (K < 0 || K > MAX_K) return -4;
    const size_t smem = pdt_fused_smem_bytes(1, nb, da, db, pr, pc, K);
    auto kern = K ? fused_bwd_kernel<true> : fused_bwd_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    Geo g = {R, n_steps, nb, da, db, pr, pc, n_eval, last_slot};
    Parts pt = {rsym, rasym, csym, casym};
    FwdStreams f;
    MirStreams m;
    for (int i = 0; i < 8; ++i) f.z[i] = zf[i];
    for (int i = 0; i < 4; ++i) m.z[i] = zb[i];
    const Kron kz = make_kron(kron_in, krbar, kcbar,
                              scratch + base_floats(1, R, S, (size_t)nb * da * db), K, 1);
    kern<<<R, NTHREADS, smem, (cudaStream_t)stream>>>(
        st_re, st_im, lam_re, lam_im, pt, f, m, hb_hi, hb_lo, hs, diag, diag_lo, slots,
        lam0_re, lam0_im, zbar, dbar, scratch, kz, g, tab, h_area(nb, da, db));
    return (int)cudaGetLastError();
}
