// Checkpointed fused ERK evolution (K4) and its adjoint from the stored
// states (K5) for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes; see pulser_diff_torch/ops/fused_evolution.py).
//
// Replaces the two Pallas kernels of pulser_diff_tpu/ops/pallas_evolution.py
// that the JAX package runs from dim 2^16 (16 atoms):
//   K4  _fwd_ckpt_kernel  (no kron pairs)  -> fused_fwd_ckpt_kernel
//   K5  _bwd_ckpt_kernel  (no kron pairs)  -> fused_bwd_ckpt_kernel
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
//     K4 takes 2S barriers per step, K5 4S - 1.
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
__device__ void products(TileSmem& t, const Geo& g, const In& in, float* scratch, size_t per_run,
                         size_t v_off, size_t side_off, size_t q_off, bool outer, size_t u_off,
                         size_t zp_off) {
    const int da = g.da, db = g.db, M = da * db, N = g.nb * M;
    const int nti = cdiv(da, TT), ntj = cdiv(db, TT);
    const int per_apply = g.nb * nti * ntj;
    const int n_or = nti * nti, n_oc = ntj * ntj;
    const int jobs = 2 * per_apply + (outer ? n_or + n_oc : 0);
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
__device__ __forceinline__ void finish_apply(const float* q, size_t N, size_t e, float x, float y,
                                             float d, float dl, float sign, float& kx, float& ky) {
    const float h_re = ((q[e] + q[2 * N + e]) + d * x) + dl * x;
    const float h_im = ((q[N + e] + q[3 * N + e]) + d * y) + dl * y;
    kx = sign * h_im;
    ky = -sign * h_re;
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
    size_t per_run;
};

__host__ __device__ inline FwdLayout fwd_layout(int S, int nb, int da, int db) {
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
    L.per_run = L.side + 2 * (size_t)da * da + 2 * (size_t)db * db;
    return L;
}

__global__ void __launch_bounds__(NTHREADS, 2)
fused_fwd_ckpt_kernel(In in, float* out_re, float* out_im, float* scratch, Barrier bar, Geo g,
                      Tab tab) {
    __shared__ TileSmem t;
    const int S = tab.S, M = g.da * g.db;
    const size_t N = (size_t)g.nb * M, RN = (size_t)g.R * N;
    const FwdLayout L = fwd_layout(S, g.nb, g.da, g.db);

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
            products(t, g, in, scratch, L.per_run, L.u, L.side, L.q, false, 0, 0);
            grid_sync(bar);
            for (size_t idx = gtid(); idx < RN; idx += gsize()) {
                const int r = (int)(idx / N);
                const size_t e = idx - (size_t)r * N;
                const int m = (int)(e % M);
                float* run = scratch + (size_t)r * L.per_run;
                float* K = run + L.k;
                float kx, ky;
                finish_apply(run + L.q, N, e, run[L.u + e], run[L.u + N + e],
                             in.diag[(size_t)r * M + m], in.diag_lo[(size_t)r * M + m], 1.f,
                             kx, ky);
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
                    run[L.cx + e] = (tt - x) - yk;
                    x = tt;
                    float y = run[L.y + e], cy = run[L.cy + e];
                    yk = dy - cy;
                    tt = y + yk;
                    run[L.cy + e] = (tt - y) - yk;
                    y = tt;
                    run[L.x + e] = x;
                    run[L.y + e] = y;
                    const size_t o = ((size_t)r * g.n_steps + k) * N + e;
                    out_re[o] = x;
                    out_im[o] = y;
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
    size_t side_sz, per_run;
    int n_or, n_oc;
};

__host__ __device__ inline BwdLayout bwd_layout(int S, int nb, int da, int db) {
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
    L.per_run = L.zp + (size_t)S * (L.n_or + L.n_oc) * ZW;
    return L;
}

// zbar[r, kk, s, :] for every run and stage from the tile partials, in a
// fixed order.
__device__ void reduce_zbar(const Geo& g, int S, const BwdLayout& L, const float* scratch,
                            float* zbar, int kk) {
    const int nrow = 2 * g.pr + 2 * g.pc;
    for (size_t idx = gtid(); idx < (size_t)g.R * S * nrow; idx += gsize()) {
        const int r = (int)(idx / ((size_t)S * nrow));
        const int rem = (int)(idx - (size_t)r * S * nrow);
        const int s = rem / nrow, q = rem % nrow;
        const float* zp = scratch + (size_t)r * L.per_run + L.zp + (size_t)s * (L.n_or + L.n_oc) * ZW;
        float v = 0.f;
        if (q < 2 * g.pr) {
            for (int t = 0; t < L.n_or; ++t) v += zp[(size_t)t * ZW + q];
        } else {
            for (int t = 0; t < L.n_oc; ++t) v += zp[(size_t)(L.n_or + t) * ZW + (q - 2 * g.pr)];
        }
        zbar[(((size_t)r * g.n_steps + kk) * S + s) * nrow + q] = v;
    }
}

// End of a step at element e: the last transpose product w_0, then the
// costate update lam += sum_s w_s (in stage order).
__device__ __forceinline__ void finish_costate(float* run, const BwdLayout& L, size_t N, size_t e,
                                               int S, float d, float dl, float& lx, float& ly) {
    float wx, wy;
    finish_apply(run + L.q, N, e, run[L.gv + e], run[L.gv + N + e], d, dl, -1.f, wx, wy);
    lx = lx + wx;
    ly = ly + wy;
    for (int s = 1; s < S; ++s) {
        lx = lx + run[L.ws + 2 * s * N + e];
        ly = ly + run[L.ws + 2 * s * N + N + e];
    }
}

__global__ void __launch_bounds__(NTHREADS, 2)
fused_bwd_ckpt_kernel(In in, float* lam0_re, float* lam0_im, float* zbar, float* dbar,
                      float* scratch, Barrier bar, Geo g, Tab tab) {
    __shared__ TileSmem t;
    const int S = tab.S, M = g.da * g.db;
    const size_t N = (size_t)g.nb * M, RM = (size_t)g.R * M, RN = (size_t)g.R * N;
    const BwdLayout L = bwd_layout(S, g.nb, g.da, g.db);

    // the costate and dbar start at zero
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
                finish_costate(run, L, N, e, S, in.diag[(size_t)r * M + m],
                               in.diag_lo[(size_t)r * M + m], lx, ly);
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
        if (it > 0) reduce_zbar(g, S, L, scratch, zbar, k + 1);
        assemble_all(in, g, S, k, 0, scratch, L.per_run, L.sides);
        grid_sync(bar);

        // forward stage recompute (the last stage's product is dead)
        for (int s = 0; s + 1 < S; ++s) {
            products(t, g, in, scratch, L.per_run, L.us + 2 * s * N, L.sides + s * L.side_sz, L.q,
                     false, 0, 0);
            grid_sync(bar);
            for (size_t idx = gtid(); idx < RN; idx += gsize()) {
                const int r = (int)(idx / N);
                const size_t e = idx - (size_t)r * N;
                const int m = (int)(e % M);
                float* run = scratch + (size_t)r * L.per_run;
                float* FK = run + L.fk;
                float kx, ky;
                finish_apply(run + L.q, N, e, run[L.us + 2 * s * N + e], run[L.us + 2 * s * N + N + e],
                             in.diag[(size_t)r * M + m], in.diag_lo[(size_t)r * M + m], 1.f, kx, ky);
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
                        finish_apply(run + L.q, N, e, run[L.gv + e], run[L.gv + N + e], d, dl,
                                     -1.f, wx, wy);
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
                }
                run[L.dacc + m] = run[L.dacc + m] + acc;
            }
            grid_sync(bar);
            products(t, g, in, scratch, L.per_run, L.gv, L.sides + s * L.side_sz, L.q, true,
                     L.us + 2 * s * N, L.zp + (size_t)s * (L.n_or + L.n_oc) * ZW);
            grid_sync(bar);
        }
    }
    // the end of step 0, then the outputs
    for (size_t idx = gtid(); idx < RN; idx += gsize()) {
        const int r = (int)(idx / N);
        const size_t e = idx - (size_t)r * N;
        const int m = (int)(e % M);
        float* run = scratch + (size_t)r * L.per_run;
        float lx = run[L.l + e], ly = run[L.l + N + e];
        finish_costate(run, L, N, e, S, in.diag[(size_t)r * M + m], in.diag_lo[(size_t)r * M + m],
                       lx, ly);
        lam0_re[idx] = lx;
        lam0_im[idx] = ly;
    }
    for (size_t idx = gtid(); idx < RM; idx += gsize()) {
        const int r = (int)(idx / M), m = (int)(idx - (size_t)r * M);
        dbar[idx] = scratch[(size_t)r * L.per_run + L.dacc + m];
    }
    reduce_zbar(g, S, L, scratch, zbar, 0);
}

// ---------------------------------------------------------------------------
// C interface (ctypes).  Every function returns 0 on success, a negative
// code for what the kernel does not take (-1 tableau, -2 parts, -3 no
// cooperative launch on this device), or the cudaError_t of the launch.
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
static int useful_blocks(int bwd, int R, int nb, int da, int db) {
    const int nti = cdiv(da, TT), ntj = cdiv(db, TT);
    int jobs = 2 * nb * nti * ntj + (bwd ? nti * nti + ntj * ntj : 0);
    jobs *= R;
    const long long elems = (long long)R * nb * da * db;
    const long long by_elems = (elems + NTHREADS - 1) / NTHREADS;
    const long long want = jobs > by_elems ? jobs : by_elems;
    return (int)(want < 1 ? 1 : want);
}

static int coop_blocks(int bwd, int R, int nb, int da, int db, int* blocks) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return -3;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bwd ? (const void*)fused_bwd_ckpt_kernel : (const void*)fused_fwd_ckpt_kernel,
        NTHREADS, 0);
    if (err != cudaSuccess) return (int)err;
    const int most = per_sm * sms, want = useful_blocks(bwd, R, nb, da, db);
    *blocks = want < most ? want : most;
    if (*blocks < 1) *blocks = 1;
    return 0;
}

extern "C" int pdt_ckpt_blocks(int bwd, int R, int nb, int da, int db) {
    int blocks = 0;
    const int err = coop_blocks(bwd, R, nb, da, db, &blocks);
    return err ? (err > 0 ? -err : err) : blocks;
}

extern "C" size_t pdt_ckpt_scratch_floats(int bwd, int R, int S, int nb, int da, int db) {
    const size_t per = bwd ? bwd_layout(S, nb, da, db).per_run : fwd_layout(S, nb, da, db).per_run;
    return (size_t)R * per;
}

static In make_in(const float* const* p, int bwd) {
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
    return in;
}

// in: psi_re, psi_im, rsym, rasym, csym, casym, 8 streams, hb_hi, hb_lo, hs, diag, diag_lo
extern "C" int pdt_ckpt_fwd(const float* const* in_ptrs, float* out_re, float* out_im,
                            float* scratch, unsigned int* bar,
                            int R, int n_steps, int nb, int da, int db, int pr, int pc, int S,
                            const double* a, const int* bnz, void* stream) {
    Tab tab;
    if (make_tab(&tab, S, a, bnz)) return -1;
    if (pr > MAX_P || pc > MAX_P) return -2;
    int blocks = 0;
    const int err = coop_blocks(0, R, nb, da, db, &blocks);
    if (err) return err;
    In in = make_in(in_ptrs, 0);
    Barrier b = {bar, bar + 1};
    Geo g = {R, n_steps, nb, da, db, pr, pc};
    void* args[] = {&in, &out_re, &out_im, &scratch, &b, &g, &tab};
    cudaError_t e = cudaLaunchCooperativeKernel((const void*)fused_fwd_ckpt_kernel, dim3(blocks),
                                                dim3(NTHREADS), args, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// in: st_re, st_im, lam_re, lam_im, then the forward kernel's inputs
extern "C" int pdt_ckpt_bwd(const float* const* in_ptrs, float* lam0_re, float* lam0_im,
                            float* zbar, float* dbar, float* scratch, unsigned int* bar,
                            int R, int n_steps, int nb, int da, int db, int pr, int pc, int S,
                            const double* a, const int* bnz, void* stream) {
    Tab tab;
    if (make_tab(&tab, S, a, bnz)) return -1;
    if (pr > MAX_P || pc > MAX_P) return -2;
    int blocks = 0;
    const int err = coop_blocks(1, R, nb, da, db, &blocks);
    if (err) return err;
    In in = make_in(in_ptrs, 1);
    Barrier b = {bar, bar + 1};
    Geo g = {R, n_steps, nb, da, db, pr, pc};
    void* args[] = {&in, &lam0_re, &lam0_im, &zbar, &dbar, &scratch, &b, &g, &tab};
    cudaError_t e = cudaLaunchCooperativeKernel((const void*)fused_bwd_ckpt_kernel, dim3(blocks),
                                                dim3(NTHREADS), args, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
