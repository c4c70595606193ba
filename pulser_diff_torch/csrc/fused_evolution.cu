// Fused compensated-f32 ERK evolution (K1) and its discrete adjoint (K2)
// for Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes; see pulser_diff_torch/ops/fused_evolution.py).
//
// Replaces the two Pallas kernels of pulser_diff_tpu/ops/pallas_evolution.py
// that the main path runs:
//   K1  _fwd_kernel  (states=True, no kron pairs)          -> fused_fwd_kernel
//   K2  _bwd_kernel via _bwd_interval_lean / _adjoint_core -> fused_bwd_kernel
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

#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_S 7
#define MAX_P 8  // row / column parts per side (a global channel needs 2)
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

// shared-memory view of one stage: side matrices + stage input / cotangent
struct Smem {
    float *hre, *him, *gre, *gim;  // Hrow re/im (da, da); Hcol^T re/im (db, db)
    float *ux, *uy;                // (nb, da, db + 1)
    float* red;                    // (NWARPS, nrow) reduction partials
};

__device__ __forceinline__ Smem carve(float* sm, const Geo& g, int harea) {
    Smem s;
    s.hre = sm;
    s.him = s.hre + g.da * g.da;
    s.gre = s.him + g.da * g.da;
    s.gim = s.gre + g.db * g.db;
    s.ux = sm + harea;
    s.uy = s.ux + g.nb * g.da * (g.db + 1);
    s.red = s.uy + g.nb * g.da * (g.db + 1);
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

// K = sign * (-i H u) for the whole state batch, u in shared memory:
//   h_re = (Hre u_x - Him u_y) + (u_x Gre - u_y Gim) + d u_x + dlo u_x
//   h_im = (Him u_x + Hre u_y) + (u_x Gim + u_y Gre) + d u_y + dlo u_y
//   -i H u = (h_im, -h_re)
// The real map F = -iH is antisymmetric (H hermitian), so F^T = -F: the
// adjoint's transpose products take sign = -1.  Every sum runs over k in
// order with one rounding per product-add, as the plain version does.
__device__ void apply_block(const Smem& sh, const Geo& g, const float* dg, const float* dl,
                            float* kx, float* ky, float sign) {
    const int da = g.da, db = g.db, ldu = db + 1, M = da * db;
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
                const float h_re = ((ra[r][c] + (c1[r][c] - c2[r][c])) + dg[m] * x) + dl[m] * x;
                const float h_im = ((rb[r][c] + (c3[r][c] + c4[r][c])) + dg[m] * y) + dl[m] * y;
                const size_t e = (size_t)b * M + m;
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
__global__ void __launch_bounds__(NTHREADS)
fused_fwd_kernel(const float* __restrict__ psi_re, const float* __restrict__ psi_im,
                 Parts pt, FwdStreams zf,
                 const float* __restrict__ hb_hi, const float* __restrict__ hb_lo,
                 const float* __restrict__ hs,
                 const float* __restrict__ diag, const float* __restrict__ diag_lo,
                 const int* __restrict__ slots,
                 float* __restrict__ out_re, float* __restrict__ out_im,
                 float* __restrict__ scratch, Geo g, Tab tab, int harea) {
    extern __shared__ float sm[];
    const Smem sh = carve(sm, g, harea);
    const int r = blockIdx.x, S = tab.S;
    const int M = g.da * g.db, N = g.nb * M;
    float* X = scratch + (size_t)r * (4 + 2 * S) * N;
    float* Y = X + N;
    float* CX = Y + N;
    float* CY = CX + N;
    float* K = CY + N;  // stage s: x at K + 2sN, y at K + 2sN + N
    const float* dg = diag + (size_t)r * M;
    const float* dl = diag_lo + (size_t)r * M;
    float* ore = out_re + (size_t)r * g.n_eval * N;
    float* oim = out_im + (size_t)r * g.n_eval * N;

    const int slot0 = slots[0];
    for (int e = threadIdx.x; e < N; e += blockDim.x) {
        const float x = psi_re[(size_t)r * N + e], y = psi_im[(size_t)r * N + e];
        X[e] = x; Y[e] = y; CX[e] = 0.f; CY[e] = 0.f;
        if (slot0 < g.n_eval) { ore[(size_t)slot0 * N + e] = x; oim[(size_t)slot0 * N + e] = y; }
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
            __syncthreads();
            apply_block(sh, g, dg, dl, K + (size_t)2 * s * N, K + (size_t)2 * s * N + N, 1.f);
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
            CX[e] = (t - x) - yk; X[e] = t; x = t;
            float y = Y[e], cy = CY[e];
            yk = dy - cy; t = y + yk;
            CY[e] = (t - y) - yk; Y[e] = t; y = t;
            if (slot < g.n_eval) { ore[(size_t)slot * N + e] = x; oim[(size_t)slot * N + e] = y; }
        }
    }
}

// ---------------------------------------------------------------------------
// K2: discrete adjoint over the steps in reverse (lean interval form)
// ---------------------------------------------------------------------------
// Block-wide sums of the per-thread cotangent partials into out[0 .. nrow).
__device__ __forceinline__ void reduce_rows(const Smem& sh, const float* acc_r, const float* acc_c,
                                            const Geo& g, float* out) {
    const int nrow = 2 * g.pr + 2 * g.pc;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
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
__device__ void stage_cotangents(const Smem& sh, const float* usx, const float* usy,
                                 const Parts& pt, const Geo& g, float* out) {
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
    reduce_rows(sh, acc_r, acc_c, g, out);
}

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
                 float* __restrict__ scratch, Geo g, Tab tab, int harea) {
    extern __shared__ float sm[];
    const Smem sh = carve(sm, g, harea);
    const int r = blockIdx.x, S = tab.S;
    const int da = g.da, db = g.db, nb = g.nb, ldu = db + 1;
    const int M = da * db, N = nb * M;
    const int nrow = 2 * g.pr + 2 * g.pc;
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
            __syncthreads();
            apply_block(sh, g, dg, dl, RK + s * twoN, RK + s * twoN + N, 1.f);
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
            __syncthreads();
            apply_block(sh, g, dg, dl, RK + s * twoN, RK + s * twoN + N, 1.f);
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
            __syncthreads();
            apply_block(sh, g, dg, dl, WS + s * twoN, WS + s * twoN + N, -1.f);
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
            stage_cotangents(sh, usx_sh, usy_sh, pt, g,
                             zbar + (((size_t)r * g.n_steps + k) * S + s) * nrow);
            __syncthreads();
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
// code for a shape the kernel does not take, or the cudaError_t of the
// launch.  Launches go to the caller's stream; nothing synchronises.
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

extern "C" size_t pdt_fused_smem_bytes(int bwd, int nb, int da, int db, int pr, int pc) {
    const size_t harea = (size_t)h_area(nb, da, db);
    const size_t usz = (size_t)2 * nb * da * (db + 1);
    const size_t red = bwd ? (size_t)NWARPS * (2 * pr + 2 * pc) : 0;
    return (harea + usz + red) * sizeof(float);
}

extern "C" size_t pdt_fused_scratch_floats(int bwd, int R, int S, int nb, int da, int db) {
    const size_t N = (size_t)nb * da * db;
    return (size_t)R * (bwd ? (4 + 6 * S) : (4 + 2 * S)) * N;
}

extern "C" int pdt_fused_fwd(const float* psi_re, const float* psi_im,
                             const float* rsym, const float* rasym,
                             const float* csym, const float* casym,
                             const float* const* zf,
                             const float* hb_hi, const float* hb_lo, const float* hs,
                             const float* diag, const float* diag_lo, const int* slots,
                             float* out_re, float* out_im, float* scratch,
                             int R, int n_steps, int nb, int da, int db, int pr, int pc,
                             int n_eval, int S, const double* a, const int* bnz,
                             void* stream) {
    Tab tab;
    if (make_tab(&tab, S, a, bnz)) return -1;
    if (pr > MAX_P || pc > MAX_P) return -2;
    const size_t smem = pdt_fused_smem_bytes(0, nb, da, db, pr, pc);
    cudaError_t err = cudaFuncSetAttribute(fused_fwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    Geo g = {R, n_steps, nb, da, db, pr, pc, n_eval, 0};
    Parts pt = {rsym, rasym, csym, casym};
    FwdStreams z;
    for (int i = 0; i < 8; ++i) z.z[i] = zf[i];
    fused_fwd_kernel<<<R, NTHREADS, smem, (cudaStream_t)stream>>>(
        psi_re, psi_im, pt, z, hb_hi, hb_lo, hs, diag, diag_lo, slots,
        out_re, out_im, scratch, g, tab, h_area(nb, da, db));
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
                             int R, int n_steps, int nb, int da, int db, int pr, int pc,
                             int n_eval, int last_slot, int S, const double* a, const int* bnz,
                             void* stream) {
    Tab tab;
    if (make_tab(&tab, S, a, bnz)) return -1;
    if (pr > MAX_P || pc > MAX_P) return -2;
    const size_t smem = pdt_fused_smem_bytes(1, nb, da, db, pr, pc);
    cudaError_t err = cudaFuncSetAttribute(fused_bwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    Geo g = {R, n_steps, nb, da, db, pr, pc, n_eval, last_slot};
    Parts pt = {rsym, rasym, csym, casym};
    FwdStreams f;
    MirStreams m;
    for (int i = 0; i < 8; ++i) f.z[i] = zf[i];
    for (int i = 0; i < 4; ++i) m.z[i] = zb[i];
    fused_bwd_kernel<<<R, NTHREADS, smem, (cudaStream_t)stream>>>(
        st_re, st_im, lam_re, lam_im, pt, f, m, hb_hi, hb_lo, hs, diag, diag_lo, slots,
        lam0_re, lam0_im, zbar, dbar, scratch, g, tab, h_area(nb, da, db));
    return (int)cudaGetLastError();
}
