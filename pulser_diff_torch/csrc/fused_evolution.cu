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
//       _kron_matrix_cotangents                              -> kron_apply,
//       kron_matrix_cotangents
// Both compute what the Pallas kernels compute; they are not a block-by-block
// translation.
//
// What bounds them on this card.  One evolution is n_steps x S dependent
// stages (166 x 6 = 996 on the 12-atom main path, 101 x 6 on the 12-atom XY
// path); every stage needs the previous one.  A stage is two block-real
// products per state, about 4.2 MFLOP at da = db = 64 (plus 33.6 MFLOP for
// K = 8 kron pairs), so the work (the bound: ~0.06 ms for K1 at 12 atoms,
// ~0.34 ms with K = 8, ~0.24 / ~1.61 ms for K2) is microseconds of the
// card's f32 rate.  What the time is made of is the serial chain: each
// stage is a few dependent product passes with barriers between them, and
// on one SM (the first form: one block per run, state and stage
// derivatives in L2-resident global scratch, kron operands and
// intermediates in global memory) no other work hides their latency.
//
// What the cluster design does about it.
//   - One thread-block cluster of C blocks per run (C a power of two, at
//     most min(da, 16); the host planner picks it, the launch checks it).
//     Block c owns rows [c da/C, (c+1) da/C) of each of the nb states: its
//     slab of the state, the Kahan words, the S stage derivatives and, in
//     K2, the costate, the reconstructed states, the forward stage inputs
//     and the transpose products live in ITS OWN shared memory.  Every
//     elementwise phase (stage combinations, the two-word h*b_s increment,
//     the Kahan update, K2's costate update and slot reloads) is local.
//   - One stage: build the stage-vector slab, publish it to a
//     double-buffered slab, one cluster barrier, then every block gathers
//     the whole stage vector from its peers' slabs through distributed
//     shared memory (DSMEM) into a local padded copy.  The row side
//     Hrow[rows, :] u then reads the whole vector, the column side
//     u[rows, :] Hcol is local.  Each block assembles its Hrow rows and the
//     whole Hcol itself from the part stacks (L2) and the stage's streams.
//     The double buffer orders the reuse, so there is one cluster barrier
//     per stage.
//   - The stage's stream words (hi and lo, 4 (pr + pc) floats) are copied
//     to shared memory once by the block and read as broadcasts while the
//     parts are summed in ascending p: both kernels take up to MAX_PARTS =
//     32 parts a side (a per-qubit noisy build has 2 ceil(n / 2), 12 at 12
//     atoms, in the same order and rounding at any count).  At 12 parts a
//     stage reads 12 + 12 part matrices from L2 against 2 + 2 for a global
//     channel.  K2's stream cotangents take the parts in chunks of P_CHUNK
//     = 8, one set of 2 P_CHUNK register partials a thread, and recompute
//     their outer products for each chunk: at most 8 parts (a global
//     channel) keep one chunk and the arithmetic of the 8-part form.
//   - Kron pairs: per term, R_k's rows and columns (for R u and R^T u) and
//     C_k (padded) are staged in shared memory; the products of the
//     block's rows (T = R u, then T C^T or T C) stay in shared memory.
//     Nothing of the stage state and no kron intermediate goes through
//     global memory.
//   - The same arithmetic as the one-block form: every k-sum in order from
//     k = 0 with one __fmaf_rn each, the terms combined in the same order,
//     so K1's states are bit for bit those of the one-block form and of the
//     checkpointed K4 (fused_ckpt.cu).  No tensor cores (TF32 keeps ~3
//     decimal digits and would break the 1e-6 bar).
//   - K2's sums over rows (the stream cotangents, the kron streams'
//     cotangents, kcbar) are per-block partials summed across the cluster
//     in fixed rank order (the zbar rows through DSMEM, kcbar through
//     per-block partial buffers in device memory); dbar and krbar belong to
//     the block that owns their rows.  No float atomics: two runs give the
//     same bits.  The order differs from the one-block form's, so K2's
//     stream and kcbar cotangents move in their last digits.
//   - The file is compiled with -fmad=false so that the compensated lines
//     (Kahan carries, two-word h*b and stream folding) round each operation
//     as written; never build it with fast-math.
// The bound (the work) is unchanged by the design; what it removes is the
// one-SM latency chain and the global round trips.  What bounds the kernels
// now is still the chain of stages, each a few microseconds of dependent
// passes: on an H100 (700 W) at 12 atoms a K1 stage took ~13 us, about 6 of
// them products, 4 the Hcol/Hrow assembly from L2, 2 the DSMEM gather and
// 1 the cluster barrier and elementwise phases; with K = 8 each kron term
// added ~6 us (staging R_k / C_k and the barriers around two product
// passes), and ~19 us in K2's matrix cotangents (kernel_phases.py measures
// the split).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

#define MAX_S 7
#define MAX_PARTS 32  // parts a side: a per-qubit (all-local) build has 2 ceil(n / 2), 18 at 18 atoms
#define P_CHUNK 8     // K2's parts per chunk of its stream cotangents (2 P_CHUNK register partials)
#define MAX_K 32  // kron pairs (12 atoms XY: 8; an SLM-masked 16-atom XY sequence: 20)
#define MAX_C 16  // blocks in a cluster (above 8 only as a non-portable size)
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define TI 2  // rows of a thread's output tile
#define TJ 2  // columns of a thread's output tile
// shared memory one block can use on Hopper (bytes)
#define SMEM_LIMIT 232448

struct Tab {
    int S;
    float a[MAX_S][MAX_S];
    int bnz[MAX_S];  // 1 where the update weight b_s is nonzero
};

// rpb: the rows of each state a block owns (da / C); r0: its first row
struct Geo {
    int R, n_steps, nb, da, db, pr, pc, n_eval, last_slot, C, rpb;
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
    float* kcpart;       // (R, C, K, db, db) per-block partials of kcbar (K2)
    int K;
};

// A block's shared memory.  Slabs are (nb, rpb, db), unpadded; the
// gathered whole vectors are (nb, da, db + 1), padded so that a warp's
// strided reads fall in distinct banks.
struct Smem {
    float *gre, *gim;   // Hcol^T re/im (db, db)
    float *hre, *him;   // Hrow re/im, the block's rows (rpb, da)
    float *fx, *fy;     // the gathered stage vector (nb, da, db + 1); K2: then B2, D2
    float *ux, *uy;     // K2 with kron pairs: the gathered stage input
    float* pub;         // published stage-vector slabs: [parity][x | y]
    float* slab;        // state / stage slabs (see the kernels)
    float* zk;          // kron stream values za (K), then zb (K)
    float *rrow, *rcol; // R_k's rows (rpb, da) and columns (rpb, da: R_k[k, r0 + i])
    float* cst;         // C_k (db, db + 1)
    float* kw;          // kron products of the block's rows, 8 x (rpb, db): T and KP, or P
    float* red;         // K2: (NWARPS, nrow) warp partials, then 2 x nrow block rows
    float* zs;          // the stage's stream words: zr, zi, wr, wi (pr each), then pc each
};

__host__ __device__ inline size_t slab_floats(int nb, int rpb, int db) {
    return (size_t)nb * rpb * db;
}

__host__ __device__ inline size_t full_floats(int nb, int da, int db) {
    return (size_t)nb * da * (db + 1);
}

// The shared-memory plan: floats of each region, in carve order.  The host
// planner (ops/fused_evolution.py: _smem_floats) repeats this formula.
__host__ __device__ inline size_t smem_floats(int bwd, int nb, int da, int db, int pr, int pc,
                                              int K, int S, int C) {
    const int rpb = da / C;
    const size_t slab = slab_floats(nb, rpb, db), full = full_floats(nb, da, db);
    size_t f = (size_t)2 * db * db + (size_t)2 * rpb * da + 2 * full + 4 * slab +
               (size_t)(bwd ? 4 + 4 * S : 4 + 2 * S) * slab;
    if (K) {
        f += (size_t)2 * K + (size_t)2 * rpb * da + (size_t)db * (db + 1) +
             (size_t)8 * rpb * db;
        if (bwd) f += 2 * full;
    }
    if (bwd) f += (size_t)(NWARPS + 2) * (2 * pr + 2 * pc + 2 * K);
    return f + (size_t)4 * (pr + pc);
}

__device__ Smem carve(float* sm, const Geo& g, int bwd, int K, int S) {
    const size_t slab = slab_floats(g.nb, g.rpb, g.db), full = full_floats(g.nb, g.da, g.db);
    Smem s = {};
    float* p = sm;
    s.gre = p; p += g.db * g.db;
    s.gim = p; p += g.db * g.db;
    s.hre = p; p += g.rpb * g.da;
    s.him = p; p += g.rpb * g.da;
    s.fx = p; p += full;
    s.fy = p; p += full;
    s.pub = p; p += 4 * slab;
    s.slab = p; p += (size_t)(bwd ? 4 + 4 * S : 4 + 2 * S) * slab;
    if (K) {
        s.zk = p; p += 2 * K;
        s.rrow = p; p += g.rpb * g.da;
        s.rcol = p; p += g.rpb * g.da;
        s.cst = p; p += g.db * (g.db + 1);
        s.kw = p; p += (size_t)8 * g.rpb * g.db;
        if (bwd) {
            s.ux = p; p += full;
            s.uy = p; p += full;
        }
    }
    if (bwd) {
        s.red = p;
        p += (size_t)(NWARPS + 2) * (2 * g.pr + 2 * g.pc + 2 * K);
    }
    s.zs = p;
    return s;
}

// The element of a (nb, rpb, db) slab at local index e, as an index into
// one (nb, da, db) state batch, for the block whose first row is r0.
__device__ __forceinline__ int slab_to_state(const Geo& g, int r0, int e) {
    const int j = e % g.db, lr = (e / g.db) % g.rpb, b = e / (g.db * g.rpb);
    return (b * g.da + r0 + lr) * g.db + j;
}

// One side's matrix elements off + l (l < n) of sum_p z_re[p] Sym_p and
// sum_p z_im[p] Asym_p (hi word, then lo word folded in before the final
// rounding; neg: the imaginary part negated), into (ore, oim).  The
// stream words zw = (zr, zi, wr, wi), P each, sit in shared memory and are
// read as broadcasts, the parts in ascending p; U elements' part loads are
// issued together through the read-only path.
__device__ __forceinline__ void assemble_side(float* ore, float* oim, const float* sym,
                                              const float* asym, size_t stride, int P, int n,
                                              int off, const float* zw, bool two_word, bool neg) {
    constexpr int U = 8;
    const float *zr = zw, *zi = zw + P, *wr = zw + 2 * P, *wi = zw + 3 * P;
    for (int base = threadIdx.x; base < n; base += blockDim.x * U) {
        float hr[U] = {}, hi[U] = {}, lr[U] = {}, li[U] = {};
        for (int p = 0; p < P; ++p) {
            const float zrp = zr[p], zip = zi[p], wrp = wr[p], wip = wi[p];
            float sv[U], av[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int l = min(base + u * (int)blockDim.x, n - 1);
                sv[u] = __ldg(sym + (size_t)p * stride + off + l);
                av[u] = __ldg(asym + (size_t)p * stride + off + l);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                hr[u] = hr[u] + zrp * sv[u];
                hi[u] = hi[u] + zip * av[u];
                if (two_word) {
                    lr[u] = lr[u] + wrp * sv[u];
                    li[u] = li[u] + wip * av[u];
                }
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int l = base + u * (int)blockDim.x;
            if (l >= n) continue;
            const float im = two_word ? hi[u] + li[u] : hi[u];
            ore[l] = two_word ? hr[u] + lr[u] : hr[u];
            oim[l] = neg ? -im : im;
        }
    }
}

// Hrow = sum_p z_re[p] Sym_p + i sum_p z_im[p] Asym_p (hi word, then lo word
// folded in before the final rounding), for the block's rows; Hcol likewise,
// whole, stored as H^T: gre = re, gim = -im.  mirror: hi word of the mirror
// streams only.  The block first copies the stage's 4 (pr + pc) stream words
// to shared memory, once (any part count up to MAX_PARTS); the caller has
// synchronised the block since the previous stage's reads.
__device__ void assemble(const Smem& sh, const Parts& pt, const float* const* z, bool two_word,
                         const Geo& g, int S, int r, int k, int s, int r0) {
    const size_t br = (((size_t)r * g.n_steps + k) * S + s) * g.pr;
    const size_t bc = (((size_t)r * g.n_steps + k) * S + s) * g.pc;
    // stream words: two-word order (hi re, hi im, lo re, lo im) per side
    const int ch = two_word ? 4 : 2;
    for (int i = threadIdx.x; i < 4 * (g.pr + g.pc); i += blockDim.x) {
        const bool row = i < 4 * g.pr;
        const int P = row ? g.pr : g.pc, j = row ? i : i - 4 * g.pr, w = j / P;
        sh.zs[i] = (w < 2 || two_word) ? z[(row ? 0 : ch) + w][(row ? br : bc) + j % P] : 0.f;
    }
    __syncthreads();
    assemble_side(sh.hre, sh.him, pt.rsym, pt.rasym, (size_t)g.da * g.da, g.pr, g.rpb * g.da,
                  r0 * g.da, sh.zs, two_word, false);
    assemble_side(sh.gre, sh.gim, pt.csym, pt.casym, (size_t)g.db * g.db, g.pc, g.db * g.db, 0,
                  sh.zs + 4 * g.pr, two_word, true);
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

// Every block copies a whole (nb, da, db) vector from the cluster's slabs
// into (dx, dy), padded, through f(x, y, dx[.], dy[.]).  src: the x slab in
// this block's shared memory (y follows at + slab); each peer holds its
// rows at the same offset.  The DSMEM loads of U elements are issued before
// their stores.
template <typename F>
__device__ void gather(const cg::cluster_group& cl, const Geo& g, float* src, float* dx,
                       float* dy, F f) {
    const int n = g.nb * g.da * g.db;
    const size_t slab = slab_floats(g.nb, g.rpb, g.db);
    constexpr int U = 4;
    if ((g.db & 3) == 0 && ((size_t)src & 15) == 0) {
        // four consecutive columns a load
        for (int base = threadIdx.x; base < n / 4; base += NTHREADS * U) {
            float4 vx[U], vy[U];
            int at[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int e = 4 * (base + u * NTHREADS);
                at[u] = -1;
                if (e < n) {
                    const int j = e % g.db, i = (e / g.db) % g.da, b = e / (g.db * g.da);
                    const float* p = cl.map_shared_rank(src, i / g.rpb);
                    const size_t o = ((size_t)b * g.rpb + i % g.rpb) * g.db + j;
                    vx[u] = *reinterpret_cast<const float4*>(p + o);
                    vy[u] = *reinterpret_cast<const float4*>(p + slab + o);
                    at[u] = (b * g.da + i) * (g.db + 1) + j;
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (at[u] < 0) continue;
                float* x = dx + at[u];
                float* y = dy + at[u];
                f(vx[u].x, vy[u].x, x[0], y[0]);
                f(vx[u].y, vy[u].y, x[1], y[1]);
                f(vx[u].z, vy[u].z, x[2], y[2]);
                f(vx[u].w, vy[u].w, x[3], y[3]);
            }
        }
        return;
    }
    for (int base = threadIdx.x; base < n; base += NTHREADS * U) {
        float vx[U], vy[U];
        int at[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = base + u * NTHREADS;
            at[u] = -1;
            if (e < n) {
                const int j = e % g.db, i = (e / g.db) % g.da, b = e / (g.db * g.da);
                const float* p = cl.map_shared_rank(src, i / g.rpb);
                const size_t o = ((size_t)b * g.rpb + i % g.rpb) * g.db + j;
                vx[u] = p[o];
                vy[u] = p[slab + o];
                at[u] = (b * g.da + i) * (g.db + 1) + j;
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (at[u] >= 0) f(vx[u], vy[u], dx[at[u]], dy[at[u]]);
        }
    }
}

__device__ __forceinline__ void gather(const cg::cluster_group& cl, const Geo& g, float* src,
                                       float* dx, float* dy) {
    gather(cl, g, src, dx, dy, [](float x, float y, float& a, float& b) { a = x; b = y; });
}

// Thread tiles of an (m, n) output: a thread owns rows ti*TI .. ti*TI+TI-1
// and columns tj + c*js (c < TJ, js = ceil(n / TJ)), so the lanes of a warp
// take consecutive columns of the same rows: their row-operand loads are
// broadcasts and their column-operand loads hit distinct banks.
struct Tiles {
    int js, tm, count;
};

__device__ __forceinline__ Tiles tiles(int m, int n) {
    Tiles t;
    t.js = (n + TJ - 1) / TJ;
    t.tm = (m + TI - 1) / TI;
    t.count = t.tm * t.js;
    return t;
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

__device__ __forceinline__ bool tile_in(const Tiles& tl, int t, int r, int c, int m, int n) {
    return (t / tl.js) * TI + r < m && t % tl.js + c * tl.js < n;
}

// A real matrix read in place: X(i, k) at p[i * rs + k * cs] (a transpose
// swaps the strides).
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

// A warp's sum of v into red[warp * nrow + col] (every lane must call).
__device__ __forceinline__ void warp_put(float v, float* red, int nrow, int col) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) * nrow + col] = v;
}

// K = sign * (-i H u) for the block's rows of the whole state batch, from
// the gathered stage vector u = (sh.fx, sh.fy):
//   h_re = (Hre u_x - Him u_y) + (u_x Gre - u_y Gim) + d u_x + dlo u_x
//   h_im = (Him u_x + Hre u_y) + (u_x Gim + u_y Gre) + d u_y + dlo u_y
//   -i H u = (h_im, -h_re)
// into the slabs (kx, ky).  The real map F = -iH is antisymmetric (H
// hermitian, kron terms included), so F^T = -F: the adjoint's transpose
// products take sign = -1.  Every sum runs over k in order with one
// rounding per product-add, as the plain version does.  KRON: (kx, ky)
// receive (h_im, h_re); kron_apply adds the kron terms and the sign.
template <bool KRON>
__device__ void apply_rows(const Smem& sh, const Geo& g, int r0, const float* dg, const float* dl,
                           float* kx, float* ky, float sign) {
    const int da = g.da, db = g.db, ldu = db + 1, rpb = g.rpb;
    const Tiles tl = tiles(rpb, db);
    for (int t = threadIdx.x; t < g.nb * tl.count; t += blockDim.x) {
        const int b = t / tl.count, tt = t % tl.count;
        int ii[TI], jj[TJ];
        tile_at(tl, tt, rpb, db, ii, jj);
        const float* xb = sh.fx + (size_t)b * da * ldu;
        const float* yb = sh.fy + (size_t)b * da * ldu;
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
                xr[r] = xb[(r0 + ii[r]) * ldu + k];
                yr[r] = yb[(r0 + ii[r]) * ldu + k];
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
                if (!tile_in(tl, tt, r, c, rpb, db)) continue;
                const int i = r0 + ii[r], j = jj[c];
                const int m = i * db + j;
                const float x = xb[i * ldu + j], y = yb[i * ldu + j];
                const float h_re = ((ra[r][c] + (c1[r][c] - c2[r][c])) + dg[m] * x) + dl[m] * x;
                const float h_im = ((rb[r][c] + (c3[r][c] + c4[r][c])) + dg[m] * y) + dl[m] * y;
                const int e = (b * rpb + ii[r]) * db + j;
                if constexpr (KRON) {
                    kx[e] = h_im;
                    ky[e] = h_re;
                } else {
                    kx[e] = sign * h_im;
                    ky[e] = -sign * h_re;
                }
            }
        }
    }
}

// st(l, ld(l)) for l < n, with U loads of a thread in flight before their
// stores.
template <typename LD, typename ST>
__device__ __forceinline__ void copy_in(int n, LD ld, ST st) {
    constexpr int U = 8;
    for (int base = threadIdx.x; base < n; base += blockDim.x * U) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) v[u] = ld(min(base + u * (int)blockDim.x, n - 1));
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (base + u * (int)blockDim.x < n) st(base + u * (int)blockDim.x, v[u]);
    }
}

// Term q's operands into shared memory: R_q's rows of the block, its
// columns (sh.rcol[i * da + k] = R_q[k, r0 + i]) and C_q (padded rows).
__device__ void stage_kron(const Smem& sh, const Kron& kz, const Geo& g, int r, int r0, int q) {
    const int da = g.da, db = g.db, ldc = db + 1;
    const float* R = kz.kr + ((size_t)r * kz.K + q) * da * da;
    const float* C = kz.kc + ((size_t)r * kz.K + q) * db * db;
    const float* Rr = R + (size_t)r0 * da;
    copy_in(g.rpb * da, [&](int l) { return __ldg(Rr + l); }, [&](int l, float v) { sh.rrow[l] = v; });
    copy_in(g.rpb * da, [&](int l) { return __ldg(R + (size_t)(l % da) * da + r0 + l / da); },
            [&](int l, float v) { sh.rcol[l] = v; });
    copy_in(db * db, [&](int l) { return __ldg(C + l); },
            [&](int l, float v) { sh.cst[(l / db) * ldc + l % db] = v; });
}

// The kron pairs' terms of -iH u for the block's rows, term by term after
// apply_rows<true>:  per term q and state b (R = R_q, C = C_q)
//   T  = R u_x, R^T u_x, R u_y, R^T u_y            (rows of the block)
//   x1 = T0 C^T, x2 = T1 C, y1 = T2 C^T, y2 = T3 C  (as _Side._kron_products)
//   h_re += za (x1 + x2) - zb (y1 - y2),  h_im += za (y1 + y2) + zb (x1 - x2)
// then (kx, ky) = sign (h_im, -h_re).  R's rows and columns and C (padded)
// are staged in shared memory, T and the four products in sh.kw.  us (K2's transpose
// application): the stage input's slab; each term's stream cotangents
//   za_bar = <T1(g_x), u_y> - <T1(g_y), u_x>,  zb_bar = -<T2(g_x), u_x> - <T2(g_y), u_y>
// (T1 = x1 + x2 is self-adjoint, T2 = x1 - x2 anti-self-adjoint) go to the
// warp partials red[., col0 + 2q], red[., col0 + 2q + 1].  The Pallas
// _kron_cotangents gives zb_bar the opposite sign; no XY gradient reaches
// it (the kron streams are constants), and the port takes the derivative's
// sign.  Starts and ends with a block barrier.
__device__ void kron_apply(const Smem& sh, const Kron& kz, const Geo& g, int r, int r0, float* kx,
                           float* ky, float sign, const float* us, int nrow, int col0) {
    const int da = g.da, db = g.db, ldu = db + 1, ldc = db + 1, rpb = g.rpb, K = kz.K;
    const int M = rpb * db;
    const size_t slab = slab_floats(g.nb, rpb, db);
    const Tiles tl = tiles(rpb, db);
    for (int q = 0; q < K; ++q) {
        __syncthreads();
        stage_kron(sh, kz, g, r, r0, q);
        const float za = sh.zk[q], zb = sh.zk[K + q];
        float va = 0.f, vb = 0.f;
        for (int b = 0; b < g.nb; ++b) {
            __syncthreads();
            for (int t = threadIdx.x; t < 4 * tl.count; t += blockDim.x) {
                const int qq = t / tl.count, tt = t % tl.count;
                int ii[TI], jj[TJ];
                tile_at(tl, tt, rpb, db, ii, jj);
                const Mat A = {(qq & 1) ? sh.rcol : sh.rrow, da, 1};
                const Mat B = {(qq < 2 ? sh.fx : sh.fy) + (size_t)b * da * ldu, ldu, 1};
                float acc[TI][TJ];
                tile_mm(A, B, da, ii, jj, acc);
#pragma unroll
                for (int a = 0; a < TI; ++a)
#pragma unroll
                    for (int c = 0; c < TJ; ++c)
                        if (tile_in(tl, tt, a, c, rpb, db)) sh.kw[qq * M + ii[a] * db + jj[c]] = acc[a][c];
            }
            __syncthreads();
            // x1, x2, y1, y2 into kw[4M .. 8M)
            for (int t = threadIdx.x; t < 4 * tl.count; t += blockDim.x) {
                const int qq = t / tl.count, tt = t % tl.count;
                int ii[TI], jj[TJ];
                tile_at(tl, tt, rpb, db, ii, jj);
                const Mat A = {sh.kw + qq * M, db, 1};
                const Mat B = (qq & 1) ? Mat{sh.cst, ldc, 1} : Mat{sh.cst, 1, ldc};
                float acc[TI][TJ];
                tile_mm(A, B, db, ii, jj, acc);
#pragma unroll
                for (int a = 0; a < TI; ++a)
#pragma unroll
                    for (int c = 0; c < TJ; ++c)
                        if (tile_in(tl, tt, a, c, rpb, db))
                            sh.kw[(4 + qq) * M + ii[a] * db + jj[c]] = acc[a][c];
            }
            __syncthreads();
            for (int l = threadIdx.x; l < M; l += blockDim.x) {
                const int e = b * M + l;
                const float x1 = sh.kw[4 * M + l], x2 = sh.kw[5 * M + l];
                const float y1 = sh.kw[6 * M + l], y2 = sh.kw[7 * M + l];
                ky[e] = ky[e] + (za * (x1 + x2) - zb * (y1 - y2));
                kx[e] = kx[e] + (za * (y1 + y2) + zb * (x1 - x2));
                if (us) {
                    const float ux = us[e], uy = us[slab + e];
                    va = va + ((x1 + x2) * uy - (y1 + y2) * ux);
                    vb = vb + ((x2 - x1) * ux + (y2 - y1) * uy);
                }
            }
        }
        if (us) {
            warp_put(va, sh.red, nrow, col0 + 2 * q);
            warp_put(vb, sh.red, nrow, col0 + 2 * q + 1);
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < (int)slab; e += blockDim.x) {
        const float h_im = kx[e], h_re = ky[e];
        kx[e] = sign * h_im;
        ky[e] = -sign * h_re;
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// K1: forward evolution writing every evaluation-slot state
// ---------------------------------------------------------------------------
// Slabs: X, Y (the state), CX, CY (its Kahan carries), then the S stage
// derivatives (x, y).  Launched as R clusters of C blocks.
template <bool KRON>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_fwd_kernel(const float* __restrict__ psi_re, const float* __restrict__ psi_im,
                 Parts pt, FwdStreams zf,
                 const float* __restrict__ hb_hi, const float* __restrict__ hb_lo,
                 const float* __restrict__ hs,
                 const float* __restrict__ diag, const float* __restrict__ diag_lo,
                 const int* __restrict__ slots,
                 float* __restrict__ out_re, float* __restrict__ out_im,
                 float* __restrict__ lo_re, float* __restrict__ lo_im,
                 Kron kz, Geo g, Tab tab) {
    extern __shared__ __align__(16) float sm[];
    const cg::cluster_group cl = cg::this_cluster();
    const int r = blockIdx.x / g.C, r0 = (int)cl.block_rank() * g.rpb, S = tab.S;
    const Smem sh = carve(sm, g, 0, kz.K, S);
    const int M = g.da * g.db, N = g.nb * M;
    const int sl = (int)slab_floats(g.nb, g.rpb, g.db);
    float* X = sh.slab;
    float* Y = X + sl;
    float* CX = Y + sl;
    float* CY = CX + sl;
    float* Kd = CY + sl;  // stage s: x at Kd + 2 s sl, y at Kd + 2 s sl + sl
    const float* dg = diag + (size_t)r * M;
    const float* dl = diag_lo + (size_t)r * M;
    float* ore = out_re + (size_t)r * g.n_eval * N;
    float* oim = out_im + (size_t)r * g.n_eval * N;
    // the slot states' low words (the negated Kahan carries), when asked for
    float* lre = lo_re ? lo_re + (size_t)r * g.n_eval * N : 0;
    float* lim = lo_im ? lo_im + (size_t)r * g.n_eval * N : 0;

    const int slot0 = slots[0];
    for (int e = threadIdx.x; e < sl; e += blockDim.x) {
        const int gi = slab_to_state(g, r0, e);
        const float x = psi_re[(size_t)r * N + gi], y = psi_im[(size_t)r * N + gi];
        X[e] = x; Y[e] = y; CX[e] = 0.f; CY[e] = 0.f;
        if (slot0 < g.n_eval) { ore[(size_t)slot0 * N + gi] = x; oim[(size_t)slot0 * N + gi] = y; }
        if (slot0 < g.n_eval && lre) {
            lre[(size_t)slot0 * N + gi] = 0.f;
            lim[(size_t)slot0 * N + gi] = 0.f;
        }
    }
    int par = 0;
    for (int k = 0; k < g.n_steps; ++k) {
        const float h = hs[k];
        for (int s = 0; s < S; ++s) {
            float* pub = sh.pub + (size_t)par * 2 * sl;
            for (int e = threadIdx.x; e < sl; e += blockDim.x) {
                float xs = X[e], ys = Y[e];
                for (int j = 0; j < s; ++j) {
                    const float a = tab.a[s][j];
                    if (a != 0.f) {
                        const float c = a * h;
                        xs = xs + c * Kd[(size_t)2 * j * sl + e];
                        ys = ys + c * Kd[(size_t)2 * j * sl + sl + e];
                    }
                }
                pub[e] = xs; pub[sl + e] = ys;
            }
            assemble(sh, pt, zf.z, true, g, S, r, k, s, r0);
            if constexpr (KRON) assemble_kron(sh, kz, true, g, S, r, k, s);
            cl.sync();
            gather(cl, g, pub, sh.fx, sh.fy);
            __syncthreads();
            float* kx = Kd + (size_t)2 * s * sl;
            apply_rows<KRON>(sh, g, r0, dg, dl, kx, kx + sl, 1.f);
            if constexpr (KRON) kron_apply(sh, kz, g, r, r0, kx, kx + sl, 1.f, nullptr, 0, 0);
            __syncthreads();
            par ^= 1;
        }
        // two-word h*b_s increment (hi words, then lo words), Kahan update
        const int slot = slots[k + 1];
        for (int e = threadIdx.x; e < sl; e += blockDim.x) {
            float dx = 0.f, dy = 0.f;
            bool first = true;
            for (int s = 0; s < S; ++s) {
                if (!tab.bnz[s]) continue;
                const float w = hb_hi[k * S + s];
                const float kx = Kd[(size_t)2 * s * sl + e], ky = Kd[(size_t)2 * s * sl + sl + e];
                if (first) { dx = w * kx; dy = w * ky; first = false; }
                else { dx = dx + w * kx; dy = dy + w * ky; }
            }
            for (int s = 0; s < S; ++s) {
                if (!tab.bnz[s]) continue;
                const float w = hb_lo[k * S + s];
                dx = dx + w * Kd[(size_t)2 * s * sl + e];
                dy = dy + w * Kd[(size_t)2 * s * sl + sl + e];
            }
            float x = X[e], cx = CX[e];
            float yk = dx - cx, t = x + yk;
            cx = (t - x) - yk; CX[e] = cx; X[e] = t; x = t;
            float y = Y[e], cy = CY[e];
            yk = dy - cy; t = y + yk;
            cy = (t - y) - yk; CY[e] = cy; Y[e] = t; y = t;
            const int gi = slab_to_state(g, r0, e);
            if (slot < g.n_eval) { ore[(size_t)slot * N + gi] = x; oim[(size_t)slot * N + gi] = y; }
            if (slot < g.n_eval && lre) {
                lre[(size_t)slot * N + gi] = -cx;
                lim[(size_t)slot * N + gi] = -cy;
            }
        }
    }
    // no block leaves while a peer may still read its slabs
    cl.sync();
}

// ---------------------------------------------------------------------------
// K2: discrete adjoint over the steps in reverse (lean interval form)
// ---------------------------------------------------------------------------
// The four sums of a split-complex outer product over one thread tile:
// p_xy = sum_k Ax By, p_yx = sum_k Ay Bx, p_xx = sum_k Ax Bx, p_yy = sum_k Ay By.
struct Outer {
    float xy[TI][TJ], yx[TI][TJ], xx[TI][TJ], yy[TI][TJ];
};

__device__ __forceinline__ void outer4(const Mat& Ax, const Mat& Ay, const Mat& Bx, const Mat& By,
                                       int kd, const int (&ii)[TI], const int (&jj)[TJ], Outer& o) {
#pragma unroll
    for (int r = 0; r < TI; ++r)
#pragma unroll
        for (int c = 0; c < TJ; ++c) o.xy[r][c] = o.yx[r][c] = o.xx[r][c] = o.yy[r][c] = 0.f;
    for (int k = 0; k < kd; ++k) {
        float ax[TI], ay[TI], bx[TJ], by[TJ];
#pragma unroll
        for (int r = 0; r < TI; ++r) {
            ax[r] = Ax.p[(size_t)ii[r] * Ax.rs + (size_t)k * Ax.cs];
            ay[r] = Ay.p[(size_t)ii[r] * Ay.rs + (size_t)k * Ay.cs];
        }
#pragma unroll
        for (int c = 0; c < TJ; ++c) {
            bx[c] = Bx.p[(size_t)k * Bx.rs + (size_t)jj[c] * Bx.cs];
            by[c] = By.p[(size_t)k * By.rs + (size_t)jj[c] * By.cs];
        }
#pragma unroll
        for (int r = 0; r < TI; ++r) {
#pragma unroll
            for (int c = 0; c < TJ; ++c) {
                o.xy[r][c] = __fmaf_rn(ax[r], by[c], o.xy[r][c]);
                o.yx[r][c] = __fmaf_rn(ay[r], bx[c], o.yx[r][c]);
                o.xx[r][c] = __fmaf_rn(ax[r], bx[c], o.xx[r][c]);
                o.yy[r][c] = __fmaf_rn(ay[r], by[c], o.yy[r][c]);
            }
        }
    }
}

// The block's partials of one stage's part-stream cotangents, g the stage
// cotangent (gathered: sh.fx / sh.fy) and u the stage input (its slab us,
// y at us + slab):
//   row side  W  = sum_b g_x u_y^T - g_y u_x^T,  V  = sum_b g_x u_x^T + g_y u_y^T  (da, da)
//   col side  Wc = sum_b u_y^T g_x - u_x^T g_y,  Vc = sum_b u_x^T g_x + u_y^T g_y  (db, db)
//   rows of zbar: (<Sym_p, W>, <Asym_p, V>)_p, then (<Sym_p, Wc>, -<Asym_p, Vc>)_p
// (the column side is stored transposed, and P^T - P = -Asym).  The block
// takes W's and V's columns of its rows (every row of g against its rows of
// u) and the terms of Wc and Vc from its rows; the warp partials go to
// red[., 0 .. 2pr + 2pc).  The parts go in chunks of P_CHUNK, each over the
// whole tile loop with its own 2 P_CHUNK register partials (a thread's tiles
// are summed before its warp's), so each chunk recomputes W and V; with at
// most P_CHUNK parts there is one chunk.
__device__ void side_cotangents(const Smem& sh, const Geo& g, int r0, const Parts& pt,
                                const float* us, int nrow) {
    const int da = g.da, db = g.db, rpb = g.rpb, ldu = db + 1;
    const size_t slab = slab_floats(g.nb, rpb, db);
    const Tiles tr = tiles(da, rpb);
    for (int c0 = 0; c0 < g.pr; c0 += P_CHUNK) {
        // the chunk's parts: np of them from rs / ra
        const int np = g.pr - c0;
        const float* rs = pt.rsym + (size_t)c0 * da * da;
        const float* ra = pt.rasym + (size_t)c0 * da * da;
        float acc[2 * P_CHUNK] = {};
        for (int t = threadIdx.x; t < tr.count; t += blockDim.x) {
            int ii[TI], jj[TJ];
            tile_at(tr, t, da, rpb, ii, jj);
            float w[TI][TJ] = {}, v[TI][TJ] = {};
            for (int b = 0; b < g.nb; ++b) {
                const Mat gx = {sh.fx + (size_t)b * da * ldu, ldu, 1};
                const Mat gy = {sh.fy + (size_t)b * da * ldu, ldu, 1};
                const Mat ux = {us + (size_t)b * rpb * db, 1, db};
                const Mat uy = {us + slab + (size_t)b * rpb * db, 1, db};
                Outer o;
                outer4(gx, gy, ux, uy, db, ii, jj, o);
#pragma unroll
                for (int a = 0; a < TI; ++a) {
#pragma unroll
                    for (int c = 0; c < TJ; ++c) {
                        w[a][c] = w[a][c] + (o.xy[a][c] - o.yx[a][c]);
                        v[a][c] = v[a][c] + (o.xx[a][c] + o.yy[a][c]);
                    }
                }
            }
#pragma unroll
            for (int a = 0; a < TI; ++a) {
#pragma unroll
                for (int c = 0; c < TJ; ++c) {
                    if (!tile_in(tr, t, a, c, da, rpb)) continue;
                    const size_t q = (size_t)ii[a] * da + r0 + jj[c];
#pragma unroll
                    for (int p = 0; p < P_CHUNK; ++p) {
                        if (p < np) {
                            acc[2 * p] = acc[2 * p] + rs[(size_t)p * da * da + q] * w[a][c];
                            acc[2 * p + 1] = acc[2 * p + 1] + ra[(size_t)p * da * da + q] * v[a][c];
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int q = 0; q < 2 * P_CHUNK; ++q)
            if (q < 2 * np) warp_put(acc[q], sh.red, nrow, 2 * c0 + q);
    }
    const Tiles tc = tiles(db, db);
    for (int c0 = 0; c0 < g.pc; c0 += P_CHUNK) {
        const int np = g.pc - c0;
        const float* cs = pt.csym + (size_t)c0 * db * db;
        const float* ca = pt.casym + (size_t)c0 * db * db;
        float acc[2 * P_CHUNK] = {};
        for (int t = threadIdx.x; t < tc.count; t += blockDim.x) {
            int ii[TI], jj[TJ];
            tile_at(tc, t, db, db, ii, jj);
            float w[TI][TJ] = {}, v[TI][TJ] = {};
            for (int b = 0; b < g.nb; ++b) {
                const Mat ux = {us + (size_t)b * rpb * db, 1, db};
                const Mat uy = {us + slab + (size_t)b * rpb * db, 1, db};
                const Mat gx = {sh.fx + (size_t)(b * da + r0) * ldu, ldu, 1};
                const Mat gy = {sh.fy + (size_t)(b * da + r0) * ldu, ldu, 1};
                Outer o;
                outer4(ux, uy, gx, gy, rpb, ii, jj, o);
#pragma unroll
                for (int a = 0; a < TI; ++a) {
#pragma unroll
                    for (int c = 0; c < TJ; ++c) {
                        w[a][c] = w[a][c] + (o.yx[a][c] - o.xy[a][c]);
                        v[a][c] = v[a][c] + (o.xx[a][c] + o.yy[a][c]);
                    }
                }
            }
#pragma unroll
            for (int a = 0; a < TI; ++a) {
#pragma unroll
                for (int c = 0; c < TJ; ++c) {
                    if (!tile_in(tc, t, a, c, db, db)) continue;
                    const size_t q = (size_t)ii[a] * db + jj[c];
#pragma unroll
                    for (int p = 0; p < P_CHUNK; ++p) {
                        if (p < np) {
                            acc[2 * p] = acc[2 * p] + cs[(size_t)p * db * db + q] * w[a][c];
                            acc[2 * p + 1] = acc[2 * p + 1] - ca[(size_t)p * db * db + q] * v[a][c];
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int q = 0; q < 2 * P_CHUNK; ++q)
            if (q < 2 * np) warp_put(acc[q], sh.red, nrow, 2 * g.pr + 2 * c0 + q);
    }
}

// The part-matrix cotangents of one stage (_kron_matrix_cotangents), from
// the stage cotangent g (its slabs in the cluster's published pair pub),
// the stage input u (gathered: sh.ux / sh.uy; its slab us), per term j and
// state b, with the coefficient fields
//   B1 = zb gx - za gy,  B2 = -zb gx - za gy,  D1 = za gx + zb gy,  D2 = za gx - zb gy,
//   krbar_j += B1 C ux^T + (ux C) B2^T + D1 C uy^T + (uy C) D2^T
//   kcbar_j += B1^T (R ux) + ux^T (R B2) + D1^T (R uy) + uy^T (R D2)
// added in that order, state after state.  Per term the whole B2, D2 go to
// (sh.fx, sh.fy), read from the peers' g slabs through DSMEM (g is no
// longer needed whole), and the block's rows of B1, D1 to the pair fl (a
// free published pair).  The block's rows of the level-1 products P (B1 C,
// ux C, D1 C, uy C, R ux, R B2, R uy, R D2) stay in sh.kw; krbar's rows of
// the block accumulate in the output, kcbar's terms from the block's rows
// in its partial buffer (summed across the cluster in rank order at the
// end).  The terms run from the last, whose operands kron_apply left
// staged (each term has accumulators of its own).  Ends with a block
// barrier.
__device__ void kron_matrix_cotangents(const Smem& sh, const cg::cluster_group& cl, const Kron& kz,
                                       const Geo& g, int r, int r0, int rank, float* pub,
                                       float* fl, const float* us) {
    const int da = g.da, db = g.db, rpb = g.rpb, ldu = db + 1, ldc = db + 1, K = kz.K;
    const int M = rpb * db;
    const int sl = (int)slab_floats(g.nb, rpb, db);
    const Tiles t1 = tiles(rpb, db), tr = tiles(rpb, da), tc = tiles(db, db);
    for (int j = K - 1; j >= 0; --j) {
        __syncthreads();
        if (j < K - 1) stage_kron(sh, kz, g, r, r0, j);
        const float za = sh.zk[j], zb = sh.zk[K + j];
        gather(cl, g, pub, sh.fx, sh.fy, [=](float gx, float gy, float& b2, float& d2) {
            b2 = -zb * gx - za * gy;
            d2 = za * gx - zb * gy;
        });
        for (int e = threadIdx.x; e < sl; e += blockDim.x) {
            const float gx = pub[e], gy = pub[sl + e];
            fl[e] = zb * gx - za * gy;
            fl[sl + e] = za * gx + zb * gy;
        }
        float* krb = kz.krbar + ((size_t)r * K + j) * da * da + (size_t)r0 * da;
        float* kcp = kz.kcpart + (((size_t)r * g.C + rank) * K + j) * db * db;
        for (int b = 0; b < g.nb; ++b) {
            // the block's rows of B1, ux, D1, uy; the whole ux, B2, uy, D2 (selected,
            // not indexed, so that they stay in registers)
            auto lhs = [&](int q) { return ((q & 1) ? us : fl) + (q >> 1) * sl + b * M; };
            auto rhs = [&](int q) {
                const float* f = (q & 1) ? (q == 1 ? sh.fx : sh.fy) : (q == 0 ? sh.ux : sh.uy);
                return f + (size_t)b * da * ldu;
            };
            __syncthreads();
            for (int t = threadIdx.x; t < 8 * t1.count; t += blockDim.x) {
                const int q = t / t1.count, tt = t % t1.count;
                int ii[TI], jj[TJ];
                tile_at(t1, tt, rpb, db, ii, jj);
                float acc[TI][TJ];
                if (q < 4)
                    tile_mm(Mat{lhs(q), db, 1}, Mat{sh.cst, ldc, 1}, db, ii, jj, acc);
                else
                    tile_mm(Mat{sh.rrow, da, 1}, Mat{rhs(q - 4), ldu, 1}, da, ii, jj, acc);
#pragma unroll
                for (int a = 0; a < TI; ++a)
#pragma unroll
                    for (int c = 0; c < TJ; ++c)
                        if (tile_in(t1, tt, a, c, rpb, db)) sh.kw[q * M + ii[a] * db + jj[c]] = acc[a][c];
            }
            __syncthreads();
            // krbar rows of the block: (rpb, db) x (db, da), P_q times ux^T, B2^T, uy^T, D2^T
            for (int t = threadIdx.x; t < tr.count; t += blockDim.x) {
                int ii[TI], jj[TJ];
                tile_at(tr, t, rpb, da, ii, jj);
                float acc[TI][TJ];
#pragma unroll
                for (int a = 0; a < TI; ++a)
#pragma unroll
                    for (int c = 0; c < TJ; ++c) acc[a][c] = krb[(size_t)ii[a] * da + jj[c]];
                for (int q = 0; q < 4; ++q) {
                    float tq[TI][TJ];
                    tile_mm(Mat{sh.kw + q * M, db, 1}, Mat{rhs(q), 1, ldu}, db, ii, jj, tq);
#pragma unroll
                    for (int a = 0; a < TI; ++a)
#pragma unroll
                        for (int c = 0; c < TJ; ++c) acc[a][c] = acc[a][c] + tq[a][c];
                }
#pragma unroll
                for (int a = 0; a < TI; ++a)
#pragma unroll
                    for (int c = 0; c < TJ; ++c)
                        if (tile_in(tr, t, a, c, rpb, da)) krb[(size_t)ii[a] * da + jj[c]] = acc[a][c];
            }
            // kcbar terms of the block's rows: (db, rpb) x (rpb, db), B1^T, ux^T, D1^T,
            // uy^T times P_{4+q}
            for (int t = threadIdx.x; t < tc.count; t += blockDim.x) {
                int ii[TI], jj[TJ];
                tile_at(tc, t, db, db, ii, jj);
                float acc[TI][TJ];
#pragma unroll
                for (int a = 0; a < TI; ++a)
#pragma unroll
                    for (int c = 0; c < TJ; ++c) acc[a][c] = kcp[(size_t)ii[a] * db + jj[c]];
                for (int q = 0; q < 4; ++q) {
                    float tq[TI][TJ];
                    tile_mm(Mat{lhs(q), 1, db}, Mat{sh.kw + (4 + q) * M, db, 1}, rpb, ii, jj, tq);
#pragma unroll
                    for (int a = 0; a < TI; ++a)
#pragma unroll
                        for (int c = 0; c < TJ; ++c) acc[a][c] = acc[a][c] + tq[a][c];
                }
#pragma unroll
                for (int a = 0; a < TI; ++a)
#pragma unroll
                    for (int c = 0; c < TJ; ++c)
                        if (tile_in(tc, t, a, c, db, db)) kcp[(size_t)ii[a] * db + jj[c]] = acc[a][c];
            }
        }
    }
    __syncthreads();
}

// Slabs: X (the state, x then y), L (the costate), S pairs RK (the mirror,
// then the forward stage derivatives; in the transpose recursion the
// transpose products WS, which reuse them), S pairs US (the forward stage
// inputs).  Launched as R clusters of C blocks.
template <bool KRON>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_bwd_kernel(const float* __restrict__ st_re, const float* __restrict__ st_im,
                 const float* __restrict__ lam_re, const float* __restrict__ lam_im,
                 Parts pt, FwdStreams zf, MirStreams zb,
                 const float* __restrict__ hb_hi, const float* __restrict__ hb_lo,
                 const float* __restrict__ hs,
                 const float* __restrict__ diag, const float* __restrict__ diag_lo,
                 const int* __restrict__ slots,
                 float* __restrict__ lam0_re, float* __restrict__ lam0_im,
                 float* __restrict__ zbar, float* __restrict__ dbar,
                 Kron kz, Geo g, Tab tab) {
    extern __shared__ __align__(16) float sm[];
    const cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank(), r = blockIdx.x / g.C, r0 = rank * g.rpb, S = tab.S;
    const Smem sh = carve(sm, g, 1, kz.K, S);
    const int da = g.da, db = g.db, M = da * db, N = g.nb * M;
    const int sl = (int)slab_floats(g.nb, g.rpb, db), sl2 = 2 * sl;
    const int nrow = 2 * g.pr + 2 * g.pc + 2 * kz.K;
    float* X = sh.slab;
    float* L = X + sl2;
    float* RK = L + sl2;  // pair s at RK + s sl2; WS reuses it
    float* US = RK + (size_t)S * sl2;
    float* part = sh.red + NWARPS * nrow;  // the block's zbar rows, two parities
    const float* dg = diag + (size_t)r * M;
    const float* dl = diag_lo + (size_t)r * M;
    float* db_out = dbar + (size_t)r * M + (size_t)r0 * db;  // the block's rows
    const float* sre = st_re + (size_t)r * g.n_eval * N;
    const float* sim = st_im + (size_t)r * g.n_eval * N;
    const float* lre = lam_re + (size_t)r * g.n_eval * N;
    const float* lim = lam_im + (size_t)r * g.n_eval * N;

    for (int e = threadIdx.x; e < sl; e += blockDim.x) {
        const size_t o = (size_t)g.last_slot * N + slab_to_state(g, r0, e);
        X[e] = sre[o]; X[sl + e] = sim[o];
        L[e] = lre[o]; L[sl + e] = lim[o];
    }
    for (int m = threadIdx.x; m < g.rpb * db; m += blockDim.x) db_out[m] = 0.f;
    if constexpr (KRON) {
        for (int q = 0; q < kz.K; ++q)
            for (int l = threadIdx.x; l < g.rpb * da; l += blockDim.x)
                kz.krbar[((size_t)r * kz.K + q) * da * da + (size_t)r0 * da + l] = 0.f;
        float* kcp = kz.kcpart + ((size_t)r * g.C + rank) * kz.K * db * db;
        for (int l = threadIdx.x; l < kz.K * db * db; l += blockDim.x) kcp[l] = 0.f;
    }

    // a finished zbar row waits in `part` until the next cluster barrier;
    // then rank 0 sums the blocks' rows in rank order
    int par = 0, zpar = 0, ppar = 0;
    long long pend = -1;
    auto flush = [&]() {
        if (pend >= 0 && rank == 0) {
            for (int c = threadIdx.x; c < nrow; c += blockDim.x) {
                float v = 0.f;
                for (int q = 0; q < g.C; ++q) v += cl.map_shared_rank(part + ppar * nrow, q)[c];
                zbar[pend + c] = v;
            }
        }
        pend = -1;
    };
    // one application of sign * (-iH) to the published stage vector: the
    // cluster barrier, the gather, the products of the block's rows into the
    // pair `out`; us (transpose recursion): the stage input's slab pair,
    // gathered too with kron pairs
    auto stage = [&](float* pub, float* out, float sign, const float* us) {
        cl.sync();
        flush();
        gather(cl, g, pub, sh.fx, sh.fy);
        if (KRON && us) gather(cl, g, const_cast<float*>(us), sh.ux, sh.uy);
        __syncthreads();
        apply_rows<KRON>(sh, g, r0, dg, dl, out, out + sl, sign);
        if constexpr (KRON)
            kron_apply(sh, kz, g, r, r0, out, out + sl, sign, us, nrow, 2 * g.pr + 2 * g.pc);
        __syncthreads();
    };

    for (int it = 0; it < g.n_steps; ++it) {
        const int k = g.n_steps - 1 - it;
        const float h = hs[k];
        // 1. reconstruct the step's start state by reverse-time ERK on the mirror streams
        for (int s = 0; s < S; ++s) {
            float* pub = sh.pub + (size_t)par * sl2;
            for (int e = threadIdx.x; e < sl; e += blockDim.x) {
                float xs = X[e], ys = X[sl + e];
                for (int j = 0; j < s; ++j) {
                    const float a = tab.a[s][j];
                    if (a != 0.f) {
                        const float c = a * h;
                        xs = xs - c * RK[j * sl2 + e];
                        ys = ys - c * RK[j * sl2 + sl + e];
                    }
                }
                pub[e] = xs; pub[sl + e] = ys;
            }
            assemble(sh, pt, zb.z, false, g, S, r, k, s, r0);
            if constexpr (KRON) assemble_kron(sh, kz, false, g, S, r, k, s);
            stage(pub, RK + s * sl2, 1.f, nullptr);
            par ^= 1;
        }
        for (int e = threadIdx.x; e < sl; e += blockDim.x) {
            float x0 = X[e], y0 = X[sl + e];
            for (int s = 0; s < S; ++s) {
                if (!tab.bnz[s]) continue;
                const float bhl = hb_hi[k * S + s] + hb_lo[k * S + s];
                x0 = x0 - bhl * RK[s * sl2 + e];
                y0 = y0 - bhl * RK[s * sl2 + sl + e];
            }
            X[e] = x0; X[sl + e] = y0;
        }
        // 2. recompute the forward stage inputs (the last stage's product is dead)
        for (int s = 0; s < S; ++s) {
            float* pub = sh.pub + (size_t)par * sl2;
            for (int e = threadIdx.x; e < sl; e += blockDim.x) {
                float xs = X[e], ys = X[sl + e];
                for (int j = 0; j < s; ++j) {
                    const float a = tab.a[s][j];
                    if (a != 0.f) {
                        const float c = a * h;
                        xs = xs + c * RK[j * sl2 + e];
                        ys = ys + c * RK[j * sl2 + sl + e];
                    }
                }
                US[s * sl2 + e] = xs; US[s * sl2 + sl + e] = ys;
                pub[e] = xs; pub[sl + e] = ys;
            }
            if (s == S - 1) break;
            assemble(sh, pt, zf.z, true, g, S, r, k, s, r0);
            if constexpr (KRON) assemble_kron(sh, kz, true, g, S, r, k, s);
            stage(pub, RK + s * sl2, 1.f, nullptr);
            par ^= 1;
        }
        __syncthreads();
        // 3. reversed transpose recursion with the cotangent work of each stage
        float* WS = RK;
        for (int s = S - 1; s >= 0; --s) {
            float* pub = sh.pub + (size_t)par * sl2;
            for (int e = threadIdx.x; e < sl; e += blockDim.x) {
                float gx = 0.f, gy = 0.f;
                if (tab.bnz[s]) {
                    const float bhl = hb_hi[k * S + s] + hb_lo[k * S + s];
                    gx = bhl * L[e]; gy = bhl * L[sl + e];
                }
                for (int rr = s + 1; rr < S; ++rr) {
                    const float a = tab.a[rr][s];
                    if (a != 0.f) {
                        const float c = a * h;
                        gx = gx + c * WS[rr * sl2 + e];
                        gy = gy + c * WS[rr * sl2 + sl + e];
                    }
                }
                pub[e] = gx; pub[sl + e] = gy;
            }
            assemble(sh, pt, zf.z, true, g, S, r, k, s, r0);
            if constexpr (KRON) assemble_kron(sh, kz, true, g, S, r, k, s);
            const float* us = US + s * sl2;
            stage(pub, WS + s * sl2, -1.f, us);
            // the diagonal's cotangent, elementwise on the block's rows
            for (int m = threadIdx.x; m < g.rpb * db; m += blockDim.x) {
                float acc = 0.f;
                for (int b = 0; b < g.nb; ++b) {
                    const int e = b * g.rpb * db + m;
                    acc = acc + (pub[e] * us[sl + e] - pub[sl + e] * us[e]);
                }
                db_out[m] = db_out[m] + acc;
            }
            side_cotangents(sh, g, r0, pt, us, nrow);
            // the other published pair is free until the next stage's build
            if constexpr (KRON)
                kron_matrix_cotangents(sh, cl, kz, g, r, r0, rank, pub,
                                       sh.pub + (size_t)(par ^ 1) * sl2, us);
            __syncthreads();
            for (int c = threadIdx.x; c < nrow; c += blockDim.x) {
                float v = 0.f;
                for (int w = 0; w < NWARPS; ++w) v += sh.red[w * nrow + c];
                part[zpar * nrow + c] = v;
            }
            pend = (((long long)r * g.n_steps + k) * S + s) * nrow;
            ppar = zpar;
            zpar ^= 1;
            par ^= 1;
            __syncthreads();
        }
        // 4. costate update, then 5. the stored state / slot cotangent at grid point k
        const int slot = slots[k];
        for (int e = threadIdx.x; e < sl; e += blockDim.x) {
            float lx = L[e], ly = L[sl + e];
            for (int s = 0; s < S; ++s) {
                lx = lx + WS[s * sl2 + e];
                ly = ly + WS[s * sl2 + sl + e];
            }
            if (slot < g.n_eval) {
                const size_t o = (size_t)slot * N + slab_to_state(g, r0, e);
                X[e] = sre[o]; X[sl + e] = sim[o];
                lx = lx + lre[o]; ly = ly + lim[o];
            }
            L[e] = lx; L[sl + e] = ly;
        }
        __syncthreads();
    }
    for (int e = threadIdx.x; e < sl; e += blockDim.x) {
        const size_t o = (size_t)r * N + slab_to_state(g, r0, e);
        lam0_re[o] = L[e];
        lam0_im[o] = L[sl + e];
    }
    cl.sync();
    flush();
    if constexpr (KRON) {
        // kcbar: the blocks' partials summed in rank order, each block a share
        const size_t n = (size_t)kz.K * db * db;
        const float* kcp = kz.kcpart + (size_t)r * g.C * n;
        for (size_t l = (size_t)rank * blockDim.x + threadIdx.x; l < n; l += (size_t)g.C * blockDim.x) {
            float v = 0.f;
            for (int q = 0; q < g.C; ++q) v += kcp[q * n + l];
            kz.kcbar[(size_t)r * n + l] = v;
        }
    }
    // no block leaves while a peer may still read its shared memory
    cl.sync();
}

// ---------------------------------------------------------------------------
// C interface (ctypes).  Every function returns 0 on success, a negative
// code for a shape or plan the kernel does not take (-1 tableau, -2 parts,
// -4 kron pairs, -5 a cluster of this size and shared memory cannot be
// scheduled on the device, -6 a cluster size the plan does not allow), or
// the cudaError_t of the launch.  Launches go to the caller's stream;
// nothing synchronises.
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

// shared memory of one block for the plan (bwd, shape, cluster size C)
extern "C" size_t pdt_fused_smem_bytes(int bwd, int nb, int da, int db, int pr, int pc, int K,
                                       int S, int C) {
    return smem_floats(bwd, nb, da, db, pr, pc, K, S, C) * sizeof(float);
}

// 0 if C is a cluster size the kernels take for this shape: a power of two
// that divides da, at most min(da, MAX_C), with the block's shared memory
// within the limit; else -6
static int plan_ok(int bwd, int nb, int da, int db, int pr, int pc, int K, int S, int C) {
    if (C < 1 || C > MAX_C || (C & (C - 1)) || da % C) return -6;
    return pdt_fused_smem_bytes(bwd, nb, da, db, pr, pc, K, S, C) <= SMEM_LIMIT ? 0 : -6;
}

// device scratch: K2's per-block kcbar partials (R, C, K, db, db)
extern "C" size_t pdt_fused_scratch_floats(int bwd, int R, int db, int K, int C) {
    return bwd ? (size_t)R * C * K * db * db : 0;
}

// kron inputs: kr, kc, the four forward-node and (K2) two mirror-node streams
static Kron make_kron(const float* const* kin, float* krbar, float* kcbar, float* kcpart, int K,
                      int bwd) {
    Kron kz = {};
    kz.K = K;
    if (!K) return kz;
    kz.kr = kin[0];
    kz.kc = kin[1];
    for (int i = 0; i < 4; ++i) kz.zf[i] = kin[2 + i];
    if (bwd) {
        kz.zb[0] = kin[6];
        kz.zb[1] = kin[7];
        kz.krbar = krbar;
        kz.kcbar = kcbar;
        kz.kcpart = kcpart;
    }
    return kz;
}

// R clusters of C blocks: the shared-memory attribute, the non-portable
// size above 8, a check that such a cluster can be resident, the launch
template <typename... Params, typename... Args>
static int launch_clusters(void (*kern)(Params...), int R, int C, size_t smem, void* stream,
                           Args... args) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (C > 8) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(R * C);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return -5;
    err = cudaLaunchKernelEx(&cfg, kern, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

static int check_shape(int S, const double* a, const int* bnz, int pr, int pc, int K, Tab* tab) {
    if (make_tab(tab, S, a, bnz)) return -1;
    if (pr > MAX_PARTS || pc > MAX_PARTS) return -2;
    if (K < 0 || K > MAX_K) return -4;
    return 0;
}

extern "C" int pdt_fused_fwd(const float* psi_re, const float* psi_im,
                             const float* rsym, const float* rasym,
                             const float* csym, const float* casym,
                             const float* const* zf,
                             const float* hb_hi, const float* hb_lo, const float* hs,
                             const float* diag, const float* diag_lo, const int* slots,
                             float* out_re, float* out_im, float* lo_re, float* lo_im,
                             const float* const* kron_in, int K,
                             int R, int n_steps, int nb, int da, int db, int pr, int pc,
                             int n_eval, int S, const double* a, const int* bnz, int C,
                             void* stream) {
    Tab tab;
    const int bad = check_shape(S, a, bnz, pr, pc, K, &tab);
    if (bad) return bad;
    if (plan_ok(0, nb, da, db, pr, pc, K, S, C)) return -6;
    const size_t smem = pdt_fused_smem_bytes(0, nb, da, db, pr, pc, K, S, C);
    Geo g = {R, n_steps, nb, da, db, pr, pc, n_eval, 0, C, da / C};
    Parts pt = {rsym, rasym, csym, casym};
    FwdStreams z;
    for (int i = 0; i < 8; ++i) z.z[i] = zf[i];
    const Kron kz = make_kron(kron_in, 0, 0, 0, K, 0);
    // the kron-pair branch is its own instantiation
    return launch_clusters(K ? fused_fwd_kernel<true> : fused_fwd_kernel<false>, R, C, smem,
                           stream, psi_re, psi_im, pt, z, hb_hi, hb_lo, hs, diag, diag_lo,
                           slots, out_re, out_im, lo_re, lo_im, kz, g, tab);
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
                             int C, void* stream) {
    Tab tab;
    const int bad = check_shape(S, a, bnz, pr, pc, K, &tab);
    if (bad) return bad;
    if (plan_ok(1, nb, da, db, pr, pc, K, S, C)) return -6;
    const size_t smem = pdt_fused_smem_bytes(1, nb, da, db, pr, pc, K, S, C);
    Geo g = {R, n_steps, nb, da, db, pr, pc, n_eval, last_slot, C, da / C};
    Parts pt = {rsym, rasym, csym, casym};
    FwdStreams f;
    MirStreams m;
    for (int i = 0; i < 8; ++i) f.z[i] = zf[i];
    for (int i = 0; i < 4; ++i) m.z[i] = zb[i];
    const Kron kz = make_kron(kron_in, krbar, kcbar, scratch, K, 1);
    return launch_clusters(K ? fused_bwd_kernel<true> : fused_bwd_kernel<false>, R, C, smem,
                           stream, st_re, st_im, lam_re, lam_im, pt, f, m, hb_hi, hb_lo, hs,
                           diag, diag_lo, slots, lam0_re, lam0_im, zbar, dbar, kz, g, tab);
}

// How many clusters of C blocks of K1 (bwd = 0) or K2 (bwd = 1) can be
// resident on the card at once (cudaOccupancyMaxActiveClusters), with the
// launch's own attributes: R runs beyond it run in waves.  Negative on error
// (-6: a plan the launch refuses; else minus the cudaError).
template <typename... Params>
static int resident_clusters(void (*kern)(Params...), int C, size_t smem) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err == cudaSuccess && C > 8)
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    return err == cudaSuccess ? clusters : -(int)err;
}

extern "C" int pdt_fused_resident_clusters(int bwd, int nb, int da, int db, int pr, int pc,
                                           int K, int S, int C) {
    if (plan_ok(bwd, nb, da, db, pr, pc, K, S, C)) return -6;
    const size_t smem = pdt_fused_smem_bytes(bwd, nb, da, db, pr, pc, K, S, C);
    if (bwd) return resident_clusters(K ? fused_bwd_kernel<true> : fused_bwd_kernel<false>, C, smem);
    return resident_clusters(K ? fused_fwd_kernel<true> : fused_fwd_kernel<false>, C, smem);
}
