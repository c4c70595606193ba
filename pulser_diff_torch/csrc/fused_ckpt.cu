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
// cotangent work) and takes a cotangent at every step.  The port also
// routes here the shapes whose state K1/K2's clusters cannot hold (14 and
// 15 atoms, state batches past nb = 2 at 12 atoms), and the noisy
// Monte-Carlo batch from 14 atoms and a noisy model's gradient from 16
// atoms: their per-qubit build has 2 ceil(n / 2) parts a side (16 at 16
// atoms), which both kernels take up to MAX_PARTS = 32: K4's assembly loops
// over any count, and K5's outer-product jobs reduce the parts in chunks of
// P_CHUNK = 8 (ZW register partials a thread, one chunk at most 8 parts).
//
// What bounds them on this card.  At 16 atoms (da = db = 256, nb = 1) one
// application of -iH is 8 real 256 x 256 x 256 products, 268 MFLOP.  The
// main path's 166 DP5 steps make K4 S = 6 applications per step (~267
// GFLOP, ~4.0 ms at 67 TFLOP/s of f32 outside the tensor cores) and K5
// (2S - 1) applications plus S sets of 8 outer products per step (~757
// GFLOP, ~11.3 ms).  Operations bound both; the stored states are 87 MB.
// Nothing of size da*da or da*db fits one block's shared memory, and every
// stage needs the whole stage vector of the one before it.
//
// What the design does about it.
//   - One cooperative launch per evolution, one 256-thread block per SM
//     (as many as the largest phase has jobs); the step and stage loops run
//     inside the kernel, and a grid barrier separates only the phases that
//     depend on each other: one per application of -iH (two with kron
//     pairs, whose C-side products need the R-side ones).  K4 takes S
//     barriers a step (2S with kron pairs), K5 2S - 1 (4S - 2).
//   - A job owns one output tile of the state for both side products: the
//     block's first 128 threads form Hrow v, the other 128 v Hcol^T, and
//     the epilogue combines them in K1's order and finishes the stage in
//     registers: the derivative, the next stage input (double-buffered) or
//     the two-word increment with the Kahan update and the stored state.
//     The next stage's side matrices are assembled in the same phase into
//     a second buffer.  In K5 the epilogue of the transpose application of
//     g_s forms w_s, the next stage cotangent g_(s-1) and its dbar term (or
//     the costate update and the next step's g_(S-1)), and the stream
//     cotangents of stage s (outer products of g_s and u_s) run as further
//     jobs of the phase that applies g_s.
//   - The product tile: each thread keeps a 2 x 2 register tile of every
//     real product (1 x 1 where 2 x 2 tiles would leave SMs idle); operands
//     sit k-major in shared memory, so at 2 x 2 a k step reads a float2 per
//     operand and part, one load per four FMAs.  k-chunks of 16 are staged
//     by cp.async through a ring of three, so the next chunks' L2 fetches
//     overlap the current chunk's FMAs; a thread's 16-byte copies are
//     planned once per tile, and every stage vector is also kept
//     transposed (written by the epilogue that forms it), so that the
//     column side and the outer products stage 16-byte rows too.  Every
//     k-sum runs in order from k = 0 with explicit __fmaf_rn, in true f32:
//     no split-K, no tensor cores (TF32 keeps ~3 decimal digits and would
//     break the 1e-6 bar).  So K4's states equal K1's bit for bit.
//   - Registers: at one block per SM the compiler may take 255 a thread.
//     The tile routine, the assembly, the job kinds other than the side
//     products and K5's phases are out of line, so that no function
//     spills (chip_smoke.py checks ptxas's report).
//   - The grid barrier: one arrival per block (per SM) on an acq_rel
//     counter; the last arrival releases a generation word that the others
//     poll with ld.acquire; a barrier that never completes traps.
//   - The stream cotangents are sums over whole (da, da) or (db, db) outer
//     products: each job writes its partial sums, which a later phase adds
//     in a fixed order; dbar is elementwise.  No float atomics, so a run
//     repeats bit for bit.
//   - Compiled with -fmad=false, as fused_evolution.cu: the compensated
//     lines round each operation as written.  Never build with fast-math.
//
// The kron pairs (K3).  Each term z_k (R_k (x) C_k) + h.c. adds 8 real
// products per application (R u and R^T u, then times C^T or C, for x and
// y): at 12 atoms XY (da = db = 64, K = 8) 33.6 MFLOP a stage beside the
// sides' 4.2 MFLOP; over the 101 steps K4 ~23 GFLOP (~0.34 ms at 67
// TFLOP/s) and K5, with the part-matrix cotangents, ~85 GFLOP (~1.27 ms).
// The R-side products are further jobs of the phase that applies the
// sides (whose epilogue then stores h's side and diagonal terms); after a
// barrier, a job owns one output tile for every term: its two 128-thread
// groups form the four C-side products of two terms at a time, and the
// epilogue adds the terms one by one in K1's order before it finishes the
// stage, so K4's states equal K1's bit for bit at K > 0 too.  In K5 those
// jobs also give the za / zb stream cotangents (per-job partials, summed
// in a fixed order), and the part-matrix cotangents (16 products per term
// and state, _kron_matrix_cotangents) run as two more sets of jobs in the
// same two phases; each krbar / kcbar element has one owner per phase,
// which accumulates it in a fixed order over every step, stage and state:
// no float atomics.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define MAX_S 7
#define MAX_PARTS 32        // row / column parts a side (18 at 18 atoms all local)
#define P_CHUNK 8           // K5's parts per chunk of an outer-product job's reduction
#define MAX_K 32            // kron pairs
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define GTHREADS 128        // a group: half a block, laid out 16 rows x 8 columns of threads
#define KC 16               // k-chunk
#define NSTAGE 3            // k-chunks in flight
#define TM_MAX 32           // output tile: (16 RM) x (8 RN), RM = RN = 2 or 1
#define TN_MAX 16
#define A_LD 36             // padded k-major rows in shared memory (16-byte multiples)
#define B_LD 20
#define ZW (2 * P_CHUNK)    // cotangent partials per job and chunk

struct Tab {
    int S;
    float a[MAX_S][MAX_S];
    int bnz[MAX_S];  // 1 where the update weight b_s is nonzero
};

struct Geo {
    int R, n_steps, nb, da, db, pr, pc;
};

// the width of a K5 outer-product job's row of partials: ZW a chunk of
// P_CHUNK parts (ZW at most P_CHUNK parts a side)
__host__ __device__ inline int zrow(const Geo& g) {
    const int p = g.pr > g.pc ? g.pr : g.pc;
    return ZW * ((p + P_CHUNK - 1) / P_CHUNK);
}

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
// Hopper primitives: cp.async, group barriers, the grid barrier's
// acquire / release operations, the shared memory, the launch
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every chunk but the newest is in shared memory
__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the 128 threads of group grp (barriers 1 and 2; 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int grp) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(GTHREADS) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// one arrival: acquire the earlier arrivals' writes, release this block's
__device__ __forceinline__ unsigned arrive(unsigned* p) {
    unsigned v;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void release_add(unsigned* p) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p) : "memory");
}

__device__ __forceinline__ float* smem_base() {
    extern __shared__ float4 dyn_smem[];
    return reinterpret_cast<float*>(dyn_smem);
}

template <class... Args>
static cudaError_t launch_grid(void (*kernel)(Args...), int blocks, size_t smem,
                               cudaStream_t stream, Args... args) {
    void* ptrs[] = {(void*)&args...};
    return cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(NTHREADS), ptrs,
                                       smem, stream);
}
// (end of the Hopper primitives)

// ---------------------------------------------------------------------------
// grid-wide barrier (all blocks are co-resident: cooperative launch)
// ---------------------------------------------------------------------------
struct Barrier {
    unsigned int* count;  // arrivals at the current barrier; 0 between barriers
    unsigned int* gen;    // barriers completed
};

// ``passed``: the barriers this block has completed, this one included
__device__ void grid_sync(const Barrier& bar, unsigned& passed) {
    ++passed;
    __syncthreads();
    if (threadIdx.x == 0) {
        if (arrive(bar.count) == gridDim.x - 1u) {
            st_relaxed(bar.count, 0u);
            release_add(bar.gen);
        } else {
            unsigned long long spins = 0;
            while (ld_acquire(bar.gen) < passed) {
                __nanosleep(32);
                // a block that never arrives: fail the launch, never hang
                if (++spins == (1ull << 29)) __trap();
            }
        }
    }
    __syncthreads();
}

__device__ __forceinline__ size_t gtid() { return (size_t)blockIdx.x * NTHREADS + threadIdx.x; }
__device__ __forceinline__ size_t gsize() { return (size_t)gridDim.x * NTHREADS; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// the product tile
// ---------------------------------------------------------------------------
struct GroupSmem {
    float a[NSTAGE][4][KC][A_LD];  // A operands, k-major: a[.][q][kk][i] = A_q(i0 + i, k0 + kk)
    float b[NSTAGE][4][KC][B_LD];  // B operands, k-major: b[.][q][kk][j] = B_q(k0 + kk, j0 + j)
};

struct BlockSmem {
    GroupSmem g[2];
    float xch[8][TM_MAX * TN_MAX];  // the groups' products, handed to the epilogue
    float red[NWARPS][ZW];          // block reductions
};

// A tile operand X(f, k), f the output row (an A operand) or column (a B
// operand) and k the contraction index: X(f, k) at p[k*ld + f] when fmaj,
// else at p[f*ld + k].
struct Src {
    const float* p;
    int ld, fmaj;
};

// Stage X(f0 + f, k0 + kk) for f < TF, kk < KC at dst[kk*LD + f] with
// cp.async, zero where f0 + f >= fext or k0 + kk >= depth.  Along f in
// 16-byte copies where the layout allows it, else one float at a time.
template <int TF, int LD>
__device__ __forceinline__ void stage(float* dst, const Src& X, int f0, int fext, int k0,
                                      int depth, int gt) {
    if (X.fmaj && (X.ld & 3) == 0 && ((uintptr_t)X.p & 15) == 0) {
        for (int v = gt; v < KC * TF / 4; v += GTHREADS) {
            const int kk = v / (TF / 4), f = (v % (TF / 4)) * 4;
            const int k = k0 + kk, fg = f0 + f;
            int n = fext - fg;
            n = n < 0 ? 0 : (n > 4 ? 4 : n);
            if (k >= depth) n = 0;
            cp_async16(dst + kk * LD + f, n ? X.p + (size_t)k * X.ld + fg : X.p, 4 * n);
        }
    } else {
        for (int v = gt; v < KC * TF; v += GTHREADS) {
            int kk, f;
            if (X.fmaj) {
                kk = v / TF;
                f = v % TF;
            } else {  // consecutive threads along k, contiguous in memory
                f = v / KC;
                kk = v % KC;
            }
            const int k = k0 + kk, fg = f0 + f;
            const bool ok = k < depth && fg < fext;
            const float* src =
                ok ? X.p + (X.fmaj ? (size_t)k * X.ld + fg : (size_t)fg * X.ld + k) : X.p;
            cp_async4(dst + kk * LD + f, src, ok ? 4 : 0);
        }
    }
}

// A thread's 16-byte copy of one operand, planned once for a tile: the
// vector at src (chunk 0) to dst, the source advancing by ``chunk`` floats
// a k-chunk; chunk < 0: not planned (the tile reaches past the operand, the
// depth is not a whole number of chunks, or the layout takes single
// floats), and ``stage`` copies the operand.
struct Vec {
    const float* src;
    int dst, chunk;
};

template <int TF, int LD>
__device__ __forceinline__ Vec plan_vec(const Src& X, int f0, int fext, int depth, int gt) {
    constexpr int VR = TF / 4;  // vectors along a k row
    Vec v = {X.p, 0, -1};
    if (!X.fmaj || (X.ld & 3) || ((uintptr_t)X.p & 15) || f0 + TF > fext || depth % KC) return v;
    const int kk = gt / VR, f = (gt % VR) * 4;
    v.chunk = KC * X.ld;
    v.dst = gt < KC * VR ? kk * LD + f : -1;  // -1: this thread copies nothing
    v.src = X.p + (size_t)kk * X.ld + f0 + f;
    return v;
}

// Which real products a tile forms: p_q = A_a(q) B_b(q).
enum Mode { CPLX, PAIR, CSIDE, QUAD };
template <int M> struct Prod;
// split complex: p0 = Ar Br, p1 = Ai Bi, p2 = Ai Br, p3 = Ar Bi
template <> struct Prod<CPLX> {
    static constexpr int NA = 2, NB = 2, NP = 4;
    __host__ __device__ static constexpr int a(int q) { return q == 1 || q == 2; }
    __host__ __device__ static constexpr int b(int q) { return q == 1 || q == 3; }
};
// two independent products: p0 = A0 B0, p1 = A1 B1
template <> struct Prod<PAIR> {
    static constexpr int NA = 2, NB = 2, NP = 2;
    __host__ __device__ static constexpr int a(int q) { return q; }
    __host__ __device__ static constexpr int b(int q) { return q; }
};
// a kron term's C-side: x1 = A0 B0, y1 = A1 B0, x2 = A2 B1, y2 = A3 B1
template <> struct Prod<CSIDE> {
    static constexpr int NA = 4, NB = 2, NP = 4;
    __host__ __device__ static constexpr int a(int q) { return q; }
    __host__ __device__ static constexpr int b(int q) { return q / 2; }
};
// four independent products: p_q = A_q B_q
template <> struct Prod<QUAD> {
    static constexpr int NA = 4, NB = 4, NP = 4;
    __host__ __device__ static constexpr int a(int q) { return q; }
    __host__ __device__ static constexpr int b(int q) { return q; }
};

// One group's tile: acc[q][r][c] = sum_k A_a(q)(i, k) B_b(q)(k, j) at
// i = i0 + 2-row or 1-row thread offset + r, j likewise, over an (m, n)
// output of depth ``depth``.  Every k-sum runs in order from k = 0 with one
// rounding per product-add (chunks past the depth are zero, which adds
// nothing: an f32 sum that starts at +0 never turns -0).  Not inlined: one
// body per mode and tile serves every job kind of all four kernels (the
// sums stay in registers; only the result leaves through acc).
template <int MODE, int RM, int RN>
__device__ __noinline__ void group_mma(GroupSmem& sm, int grp, const Src* A, const Src* B, int m,
                                       int n, int depth, int i0, int j0,
                                       float (&acc)[Prod<MODE>::NP][RM][RN]) {
    using P = Prod<MODE>;
    constexpr int TM = 16 * RM, TN = 8 * RN;
    // the kron modes' six or eight operands set the kernels' register count:
    // there no copy plans, and no unrolled k steps
    constexpr bool WIDE = P::NA + P::NB > 4;
    constexpr int UNROLL = WIDE ? 1 : 4;
    const int gt = threadIdx.x - grp * GTHREADS, tr = gt / 8, tc = gt % 8;
    float sum[P::NP][RM][RN];
#pragma unroll
    for (int q = 0; q < P::NP; ++q)
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int c = 0; c < RN; ++c) sum[q][r][c] = 0.f;
    const int nch = cdiv(depth, KC);
    Vec va[P::NA], vb[P::NB];
#pragma unroll
    for (int q = 0; q < P::NA; ++q)
        va[q] = WIDE ? Vec{A[q].p, 0, -1} : plan_vec<TM, A_LD>(A[q], i0, m, depth, gt);
#pragma unroll
    for (int q = 0; q < P::NB; ++q)
        vb[q] = WIDE ? Vec{B[q].p, 0, -1} : plan_vec<TN, B_LD>(B[q], j0, n, depth, gt);
    auto fetch = [&](int c) {
        const int st = c % NSTAGE;
#pragma unroll
        for (int q = 0; q < P::NA; ++q) {
            float* dst = &sm.a[st][q][0][0];
            if (va[q].chunk < 0) stage<TM, A_LD>(dst, A[q], i0, m, c * KC, depth, gt);
            else if (va[q].dst >= 0) cp_async16(dst + va[q].dst, va[q].src + (size_t)c * va[q].chunk, 16);
        }
#pragma unroll
        for (int q = 0; q < P::NB; ++q) {
            float* dst = &sm.b[st][q][0][0];
            if (vb[q].chunk < 0) stage<TN, B_LD>(dst, B[q], j0, n, c * KC, depth, gt);
            else if (vb[q].dst >= 0) cp_async16(dst + vb[q].dst, vb[q].src + (size_t)c * vb[q].chunk, 16);
        }
    };
    group_sync(grp);  // the ring's last readers are done
    if (nch > 0) fetch(0);
    cp_async_commit();
    if (nch > 1) fetch(1);
    cp_async_commit();
    for (int c = 0; c < nch; ++c) {
        cp_async_wait1();
        group_sync(grp);  // chunk c is in; chunk c - 1's stage is free
        if (c + 2 < nch) fetch(c + 2);
        cp_async_commit();
        const int st = c % NSTAGE;
#pragma unroll (UNROLL)
        for (int kk = 0; kk < KC; ++kk) {
            float av[P::NA][RM], bv[P::NB][RN];
#pragma unroll
            for (int q = 0; q < P::NA; ++q) {
                if constexpr (RM == 2) {
                    const float2 t = *reinterpret_cast<const float2*>(&sm.a[st][q][kk][2 * tr]);
                    av[q][0] = t.x;
                    av[q][1] = t.y;
                } else {
                    av[q][0] = sm.a[st][q][kk][tr];
                }
            }
#pragma unroll
            for (int q = 0; q < P::NB; ++q) {
                if constexpr (RN == 2) {
                    const float2 t = *reinterpret_cast<const float2*>(&sm.b[st][q][kk][2 * tc]);
                    bv[q][0] = t.x;
                    bv[q][1] = t.y;
                } else {
                    bv[q][0] = sm.b[st][q][kk][tc];
                }
            }
#pragma unroll
            for (int q = 0; q < P::NP; ++q)
#pragma unroll
                for (int r = 0; r < RM; ++r)
#pragma unroll
                    for (int c2 = 0; c2 < RN; ++c2)
                        sum[q][r][c2] = __fmaf_rn(av[P::a(q)][r], bv[P::b(q)][c2], sum[q][r][c2]);
        }
    }
#pragma unroll
    for (int q = 0; q < P::NP; ++q)
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int c = 0; c < RN; ++c) acc[q][r][c] = sum[q][r][c];
}

// the tile element (row, column) of a group thread's register (r, c)
template <int RM, int RN>
__device__ __forceinline__ int tile_row(int r) { return ((threadIdx.x % GTHREADS) / 8) * RM + r; }
template <int RM, int RN>
__device__ __forceinline__ int tile_col(int c) { return ((threadIdx.x % GTHREADS) % 8) * RN + c; }

// Block sum of each thread's partials into out[0 .. nq), in a fixed order.
__device__ __forceinline__ void block_reduce(BlockSmem& sm, const float (&acc)[ZW], int nq,
                                             float* out, bool add) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // the last reduction's reads are done
#pragma unroll
    for (int q = 0; q < ZW; ++q) {
        float v = acc[q];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) sm.red[warp][q] = v;
    }
    __syncthreads();
    if (threadIdx.x < nq) {
        float v = 0.f;
        for (int w = 0; w < NWARPS; ++w) v += sm.red[w][threadIdx.x];
        out[threadIdx.x] = add ? out[threadIdx.x] + v : v;
    }
}

// ---------------------------------------------------------------------------
// the launch plan (mirrored on the host by ops/fused_evolution.ckpt_plan)
// ---------------------------------------------------------------------------
struct Plan {
    int rm, rn;        // a thread's register tile: output tile (16 rm) x (8 rn)
    int tiles;         // output tiles of one state: cdiv(da, 16 rm) * cdiv(db, 8 rn)
    int jobs;          // the largest phase's jobs (all runs)
    int per_step;      // grid barriers per step
};

// double tiles ((32 rm) x (8 rn), one half per group) of an (n1, n2) output
__host__ __device__ __forceinline__ int dtiles(int n1, int n2, int rm, int rn) {
    return cdiv(n1, 32 * rm) * cdiv(n2, 8 * rn);
}

// The tile: 2 x 2 registers a thread (32 x 16 outputs a job) where its
// tiles come to at least three quarters of the SMs, else 1 x 1 (16 x 8).
// Jobs per phase (per run):
//   K4  A: tiles + 2 K nb dt;  B (K > 0): tiles
//   K5  forward A: tiles + 2 K nb dt;  forward B (K > 0): tiles;
//       reverse A: tiles + 2 K nb dt + 4 K nb dt + outer;  reverse B: tiles + K mat
// (dt: double tiles of (da, db); outer: of (da, da) and (db, db); mat the same).
__host__ __device__ inline Plan make_plan(int bwd, int R, int nb, int da, int db, int K, int S,
                                          int sms) {
    Plan p;
    p.rm = p.rn = (4 * R * cdiv(da, 32) * cdiv(db, 16) >= 3 * sms) ? 2 : 1;
    p.tiles = cdiv(da, 16 * p.rm) * cdiv(db, 8 * p.rn);
    const int dt = dtiles(da, db, p.rm, p.rn);
    const int outer = dtiles(da, da, p.rm, p.rn) + dtiles(db, db, p.rm, p.rn);
    int most = p.tiles + 2 * K * nb * dt;
    if (bwd) {
        const int rev_a = p.tiles + 2 * K * nb * dt + 4 * K * nb * dt + outer;
        const int rev_b = p.tiles + K * outer;
        most = most > rev_a ? most : rev_a;
        most = most > rev_b ? most : rev_b;
    }
    p.jobs = R * most;
    p.per_step = (bwd ? 2 * S - 1 : S) * (K ? 2 : 1);
    return p;
}

// ---------------------------------------------------------------------------
// sides and element-wise pieces
// ---------------------------------------------------------------------------
// Side matrices of one stage inside a run's scratch: Hrow stored transposed
// (hre/him at kk*da + i hold Hrow(i, kk): the row-side products read it
// k-major), Hcol^T re/im (db, db) as K1 keeps it.
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

__host__ __device__ __forceinline__ size_t side_floats(int da, int db) {
    return 2 * (size_t)da * da + 2 * (size_t)db * db;
}

// Hrow = sum_p z_re[p] Sym_p + i sum_p z_im[p] Asym_p (hi word, then the lo
// word folded in before the final rounding); Hcol likewise, stored as H^T:
// gre = re, gim = -im.  K1's formula, element by element, over every
// element of both sides of every run.  Hrow is stored transposed, and Sym_p
// is symmetric and Asym_p antisymmetric exactly, so Hrow(i, kk), stored at
// kk*da + i, is the formula at that index with the Asym terms negated: the
// same roundings with the opposite sign (a zero may turn -0, which adds
// nothing to a product's sum).
__device__ __noinline__ void assemble_all(const In& in, const Geo& g, int S, int k, int s,
                                          float* scratch, size_t per_run, size_t side_off) {
    constexpr int U = 4;  // elements a thread assembles at once, their loads in flight together
    const size_t stride = gsize();
    for (int col = 0; col < 2; ++col) {
        const int n = col ? g.db : g.da, P = col ? g.pc : g.pr;
        const size_t sz = (size_t)n * n, total = (size_t)g.R * sz;
        const float* sym = col ? in.csym : in.rsym;
        const float* asym = col ? in.casym : in.rasym;
        const float* const* z = in.z + (col ? 4 : 0);  // hi re, hi im, lo re, lo im
        for (size_t i0 = gtid(); i0 < total; i0 += U * stride) {
            float hr[U] = {}, hi[U] = {}, lr[U] = {}, li[U] = {};
            for (int p = 0; p < P; ++p) {
                float sv[U], av[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const size_t idx = i0 + u * stride, e = idx % sz;
                    sv[u] = idx < total ? sym[p * sz + e] : 0.f;
                    av[u] = idx < total ? asym[p * sz + e] : 0.f;
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const size_t idx = i0 + u * stride;
                    if (idx >= total) continue;
                    const size_t base = (((idx / sz) * g.n_steps + k) * S + s) * P + p;
                    hr[u] = hr[u] + z[0][base] * sv[u];
                    hi[u] = hi[u] + z[1][base] * av[u];
                    lr[u] = lr[u] + z[2][base] * sv[u];
                    li[u] = li[u] + z[3][base] * av[u];
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const size_t idx = i0 + u * stride;
                if (idx >= total) continue;
                const Side sd = side_at(scratch + (idx / sz) * per_run + side_off, g.da, g.db);
                const size_t e = idx % sz;
                float* re = col ? sd.gre : sd.hre;
                float* im = col ? sd.gim : sd.him;
                re[e] = hr[u] + lr[u];
                im[e] = -(hi[u] + li[u]);
            }
        }
    }
}

// -i H v's side and diagonal terms at tile element o (products RA, RB, CA,
// CB in xch[0..3]) for the stage vector (x, y) there, in K1's order:
//   h_re = ((RA + CA) + d x) + dlo x,  h_im = ((RB + CB) + d y) + dlo y.
__device__ __forceinline__ void side_terms(const BlockSmem& sm, int o, float x, float y, float d,
                                           float dl, float& h_re, float& h_im) {
    h_re = ((sm.xch[0][o] + sm.xch[2][o]) + d * x) + dl * x;
    h_im = ((sm.xch[1][o] + sm.xch[3][o]) + d * y) + dl * y;
}

// one kron term, after the side and diagonal terms and the earlier terms:
//   h_re += za T1(x) - zb T2(y),  h_im += za T1(y) + zb T2(x)
// with T1 = x1 + x2 (or y1 + y2), T2 = x1 - x2 (y1 - y2).
__device__ __forceinline__ void kron_term(float za, float zb, float x1, float y1, float x2,
                                          float y2, float& h_re, float& h_im) {
    h_re = h_re + (za * (x1 + x2) - zb * (y1 - y2));
    h_im = h_im + (za * (y1 + y2) + zb * (x1 - x2));
}

// the kron streams' offset at run r, step k, stage s
__device__ __forceinline__ size_t zk_at(const Geo& g, int S, int K, int r, int k, int s) {
    return (((size_t)r * g.n_steps + k) * S + s) * K;
}

// The products of -iH's two sides at output tile (i0, j0) of one state v:
// group 0 the row side Hrow v, group 1 the column side v Hcol^T, combined
// as K1 combines them into xch[0..3]:
//   RA = Hre vx - Him vy, RB = Him vx + Hre vy,
//   CA = vx Gre - vy Gim, CB = vx Gim + vy Gre.
// (vtre, vtim: v transposed, from which the column side stages its rows in
// 16-byte copies; null: v itself, one float at a time)
template <int RM, int RN>
__device__ void apply_tile(BlockSmem& sm, const Geo& g, const Side& sd, const float* vre,
                           const float* vim, const float* vtre, const float* vtim, int i0,
                           int j0) {
    constexpr int TN = 8 * RN;
    const int grp = threadIdx.x / GTHREADS;
    float p[4][RM][RN];
    if (grp == 0) {
        const Src A[2] = {{sd.hre, g.da, 1}, {sd.him, g.da, 1}};
        const Src B[2] = {{vre, g.db, 1}, {vim, g.db, 1}};
        group_mma<CPLX, RM, RN>(sm.g[0], 0, A, B, g.da, g.db, g.da, i0, j0, p);
    } else {
        Src A[2];
        if (vtre) {
            A[0] = {vtre, g.da, 1};
            A[1] = {vtim, g.da, 1};
        } else {
            A[0] = {vre, g.db, 0};
            A[1] = {vim, g.db, 0};
        }
        const Src B[2] = {{sd.gre, g.db, 1}, {sd.gim, g.db, 1}};
        group_mma<CPLX, RM, RN>(sm.g[1], 1, A, B, g.da, g.db, g.db, i0, j0, p);
    }
    __syncthreads();  // the last epilogue's reads of xch are done
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
            const int o = tile_row<RM, RN>(r) * TN + tile_col<RM, RN>(c);
            sm.xch[2 * grp][o] = p[0][r][c] - p[1][r][c];
            sm.xch[2 * grp + 1][o] = grp ? p[3][r][c] + p[2][r][c] : p[2][r][c] + p[3][r][c];
        }
    __syncthreads();
}

// A PAIR result into o1, o2, both (m, n) dense.
template <int RM, int RN>
__device__ __forceinline__ void store_pair(const float (&p)[2][RM][RN], float* o1, float* o2,
                                           int m, int n, int i0, int j0) {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
            const int i = i0 + tile_row<RM, RN>(r), j = j0 + tile_col<RM, RN>(c);
            if (i < m && j < n) {
                o1[(size_t)i * n + j] = p[0][r][c];
                o2[(size_t)i * n + j] = p[1][r][c];
            }
        }
}

// One R-side kron job of run r: over (term, op, state b, double tile),
// op(R_k) v_x and op(R_k) v_y for op = R, then R^T, into kt (per term
// R v_x, R v_y, R^T v_x, R^T v_y, each N).
template <int RM, int RN>
__device__ __noinline__ void kron_rside(BlockSmem& sm, const Geo& g, const In& in, int r, int jj,
                           const float* vre, const float* vim, float* kt) {
    constexpr int TM = 16 * RM, TN = 8 * RN;
    const int da = g.da, db = g.db, ntj = cdiv(db, TN), dt = dtiles(da, db, RM, RN);
    const size_t M = (size_t)da * db, N = g.nb * M;
    const int per = g.nb * dt, term = jj / (2 * per), w = (jj / per) % 2, rem = jj % per;
    const int b = rem / dt, t = rem % dt, grp = threadIdx.x / GTHREADS;
    const int i0 = (t / ntj) * 2 * TM + grp * TM, j0 = (t % ntj) * TN;
    const float* R = in.kr + ((size_t)r * in.K + term) * da * da;
    // R(i, k) at R[i*da + k]; R^T(i, k) at R[k*da + i]
    const Src A[2] = {{R, da, w}, {R, da, w}};
    const Src B[2] = {{vre + b * M, db, 1}, {vim + b * M, db, 1}};
    float p[2][RM][RN];
    group_mma<PAIR, RM, RN>(sm.g[grp], grp, A, B, da, db, da, i0, j0, p);
    float* o = kt + (size_t)(4 * term + 2 * w) * N + b * M;
    store_pair<RM, RN>(p, o, o + N, da, db, i0, j0);
}

// The kron terms at output tile (i0, j0) of state b, added to the
// epilogue's h (its elements o = threadIdx.x + t NTHREADS) term by term in
// K1's order: the two groups form the C-side products x1 = (R v_x) C^T,
// y1, x2 = (R^T v_x) C, y2 of two terms at a time from kt.  With zp (K5's
// transposed application of v = g against the stage input u = (ux, uy)),
// each term's stream-cotangent partials over the tile (the derivative's
// sign; see fused_evolution.cu),
//   za_bar = <T1(g_x), u_y> - <T1(g_y), u_x>,  zb_bar = -<T2(g_x), u_x> - <T2(g_y), u_y>,
// go to zp[2 term], zp[2 term + 1] (added to them past the first state).
template <int RM, int RN>
__device__ __noinline__ void kron_cside(BlockSmem& sm, const Geo& g, const In& in, int r, const float* kt,
                           int b, int i0, int j0, size_t zoff, float (&h_re)[2],
                           float (&h_im)[2], const float* ux, const float* uy, float* zp) {
    constexpr int TM = 16 * RM, TN = 8 * RN, NE = (TM * TN + NTHREADS - 1) / NTHREADS;
    const int da = g.da, db = g.db, K = in.K;
    const size_t M = (size_t)da * db, N = g.nb * M;
    const int grp = threadIdx.x / GTHREADS;
    for (int j2 = 0; j2 < K; j2 += 2) {
        const int term = j2 + grp;
        float p[4][RM][RN];
        if (term < K) {
            const float* T = kt + (size_t)4 * term * N + b * M;
            const float* C = in.kc + ((size_t)r * K + term) * db * db;
            const Src A[4] = {{T, db, 0}, {T + N, db, 0}, {T + 2 * N, db, 0}, {T + 3 * N, db, 0}};
            // C^T(k, j) at C[j*db + k]; C(k, j) at C[k*db + j]
            const Src B[2] = {{C, db, 0}, {C, db, 1}};
            group_mma<CSIDE, RM, RN>(sm.g[grp], grp, A, B, da, db, db, i0, j0, p);
        }
        __syncthreads();  // the last pair's reads of xch are done
        if (term < K) {
#pragma unroll
            for (int r2 = 0; r2 < RM; ++r2)
#pragma unroll
                for (int c = 0; c < RN; ++c) {
                    const int o = tile_row<RM, RN>(r2) * TN + tile_col<RM, RN>(c);
#pragma unroll
                    for (int q = 0; q < 4; ++q) sm.xch[4 * grp + q][o] = p[q][r2][c];
                }
        }
        __syncthreads();
        float acc[ZW] = {};
#pragma unroll
        for (int t = 0; t < NE; ++t) {
            const int o = threadIdx.x + t * NTHREADS, i = i0 + o / TN, j = j0 + o % TN;
            if (o >= TM * TN || i >= da || j >= db) continue;
            const size_t e = (size_t)b * M + (size_t)i * db + j;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                if (j2 + q >= K) continue;
                const float x1 = sm.xch[4 * q][o], y1 = sm.xch[4 * q + 1][o];
                const float x2 = sm.xch[4 * q + 2][o], y2 = sm.xch[4 * q + 3][o];
                const float za = in.zk[0][zoff + j2 + q] + in.zk[2][zoff + j2 + q];
                const float zb = in.zk[1][zoff + j2 + q] + in.zk[3][zoff + j2 + q];
                kron_term(za, zb, x1, y1, x2, y2, h_re[t], h_im[t]);
                if (zp) {
                    const float vx = ux[e], vy = uy[e];
                    acc[2 * q] = acc[2 * q] + (x1 * vy - y1 * vx);
                    acc[2 * q] = acc[2 * q] + (x2 * vy - y2 * vx);
                    acc[2 * q + 1] = acc[2 * q + 1] - (x1 * vx + y1 * vy);
                    acc[2 * q + 1] = acc[2 * q + 1] + (x2 * vx + y2 * vy);
                }
            }
        }
        if (zp) block_reduce(sm, acc, 2 * (K - j2 < 2 ? K - j2 : 2), zp + 2 * j2, b > 0);
    }
}

// ---------------------------------------------------------------------------
// K4: forward evolution storing the state after every step
// ---------------------------------------------------------------------------
// (offsets in 32 bits: fewer registers held through the kernel; the
// launch refuses a run's scratch past 2^32 floats)
struct FwdLayout {  // float offsets inside one run's scratch (N = nb*da*db)
    unsigned x, y, cx, cy;  // state and Kahan carries
    unsigned u[2];          // stage vector (re N, im N), double-buffered
    unsigned ut[2];         // the same transposed: state b's (j, i) at b*da*db + j*da + i
    unsigned k;             // stage derivatives: stage s re at k + 2sN, im at k + 2sN + N
    unsigned q;             // kron pairs: h's side and diagonal terms (re N, im N)
    unsigned side[2];       // side matrices, double-buffered
    unsigned kt;            // kron R-side products, 4 K N
    size_t per_run;
};

__host__ __device__ inline FwdLayout fwd_layout(int S, int nb, int da, int db, int K) {
    const size_t N = (size_t)nb * da * db;
    FwdLayout L;
    L.x = 0;
    L.y = N;
    L.cx = 2 * N;
    L.cy = 3 * N;
    L.u[0] = 4 * N;
    L.u[1] = 6 * N;
    L.ut[0] = 8 * N;
    L.ut[1] = 10 * N;
    L.k = 12 * N;
    L.q = L.k + 2 * (size_t)S * N;
    L.side[0] = L.q + 2 * N;
    L.side[1] = L.side[0] + side_floats(da, db);
    L.kt = L.side[1] + side_floats(da, db);
    // the same sum in 64 bits (the launch checks it against 2^32)
    L.per_run = (size_t)(14 + 2 * S) * N + 2 * side_floats(da, db) + 4 * (size_t)K * N;
    return L;
}

struct FwdOut {
    float *re, *im, *lo_re, *lo_im;
};

// Stage values 0 .. MAX_S - 1 of one element into registers, every load in
// flight at once: stage j < upto from V (re at 2jN + e, im at 2jN + N + e),
// stage ``cur`` the value just formed, the rest 0.
__device__ __forceinline__ void load_stages(const float* V, size_t N, size_t e, int upto, int cur,
                                            float cx, float cy, float (&vx)[MAX_S],
                                            float (&vy)[MAX_S]) {
#pragma unroll
    for (int j = 0; j < MAX_S; ++j) {
        vx[j] = 0.f;
        vy[j] = 0.f;
        if (j < upto) {
            vx[j] = V[2 * j * N + e];
            vy[j] = V[2 * j * N + N + e];
        }
        if (j == cur) {
            vx[j] = cx;
            vy[j] = cy;
        }
    }
}

// x + sum_(j <= s) (a[s+1][j] h) k_j over the nonzero coefficients, in order
__device__ __forceinline__ void stage_input_sum(const Tab& tab, int s, float h, const float (&kx)[MAX_S],
                                                const float (&ky)[MAX_S], float& xs, float& ys) {
#pragma unroll
    for (int j = 0; j < MAX_S; ++j) {
        if (j <= s) {
            const float a = tab.a[s + 1][j];
            if (a != 0.f) {
                const float c = a * h;
                xs = xs + c * kx[j];
                ys = ys + c * ky[j];
            }
        }
    }
}

// The end of K4's stage s of step k at element e of run r (eT: its index
// transposed), from h = -iH u's parts (K1's order): the stage derivative,
// then the next stage input into u[nxt], or the two-word h*b_s increment
// (hi words, then lo words) with the Kahan update, the stored state and the
// next step's first input.
__device__ __forceinline__ void fwd_stage_end(float* run, const FwdLayout& L, const In& in,
                                              const Geo& g, const Tab& tab, const FwdOut& out,
                                              int r, int k, int s, int nxt, size_t N, size_t e,
                                              size_t eT, float h_re, float h_im) {
    const int S = tab.S;
    const float h = in.hs[k];
    float* K = run + L.k;
    K[2 * s * N + e] = h_im;
    K[2 * s * N + N + e] = -h_re;
    float kx[MAX_S], ky[MAX_S];
    load_stages(K, N, e, s, s, h_im, -h_re, kx, ky);
    float x = run[L.x + e], y = run[L.y + e];
    if (s + 1 < S) {
        float xs = x, ys = y;
        stage_input_sum(tab, s, h, kx, ky, xs, ys);
        run[L.u[nxt] + e] = xs;
        run[L.u[nxt] + N + e] = ys;
        run[L.ut[nxt] + eT] = xs;
        run[L.ut[nxt] + N + eT] = ys;
        return;
    }
    float dx = 0.f, dy = 0.f;
    bool first = true;
#pragma unroll
    for (int s2 = 0; s2 < MAX_S; ++s2) {
        if (s2 >= S || !tab.bnz[s2]) continue;
        const float w = in.hb_hi[k * S + s2];
        if (first) {
            dx = w * kx[s2];
            dy = w * ky[s2];
            first = false;
        } else {
            dx = dx + w * kx[s2];
            dy = dy + w * ky[s2];
        }
    }
#pragma unroll
    for (int s2 = 0; s2 < MAX_S; ++s2) {
        if (s2 >= S || !tab.bnz[s2]) continue;
        const float w = in.hb_lo[k * S + s2];
        dx = dx + w * kx[s2];
        dy = dy + w * ky[s2];
    }
    float cx = run[L.cx + e], cy = run[L.cy + e];
    float yk = dx - cx, tt = x + yk;
    cx = (tt - x) - yk;
    run[L.cx + e] = cx;
    x = tt;
    yk = dy - cy;
    tt = y + yk;
    cy = (tt - y) - yk;
    run[L.cy + e] = cy;
    y = tt;
    run[L.x + e] = x;
    run[L.y + e] = y;
    const size_t o = ((size_t)r * g.n_steps + k) * N + e;
    out.re[o] = x;
    out.im[o] = y;
    if (out.lo_re) {  // the low words (negated Kahan carries), when asked for
        out.lo_re[o] = -cx;
        out.lo_im[o] = -cy;
    }
    run[L.u[nxt] + e] = x;  // the next step's first stage input
    run[L.u[nxt] + N + e] = y;
    run[L.ut[nxt] + eT] = x;
    run[L.ut[nxt] + N + eT] = y;
}

// K4's phase of stage s (step k): the side products of every state at every
// tile, their epilogue (the stage's end, or with kron pairs h's side and
// diagonal terms into q), and the R-side kron jobs.
template <bool KRON, int RM, int RN>
__device__ void fwd_phase_a(BlockSmem& sm, const In& in, const Geo& g, const Tab& tab,
                            const FwdLayout& L, const FwdOut& out, float* scratch,
                            const Plan& pl, int k, int s, int cur) {
    constexpr int TM = 16 * RM, TN = 8 * RN, NE = (TM * TN + NTHREADS - 1) / NTHREADS;
    const int da = g.da, db = g.db, M = da * db, ntj = cdiv(db, TN);
    const size_t N = (size_t)g.nb * M;
    const int per = pl.tiles + (KRON ? 2 * in.K * g.nb * dtiles(da, db, RM, RN) : 0);
    for (int job = blockIdx.x; job < g.R * per; job += gridDim.x) {
        const int r = job / per, j = job % per;
        float* run = scratch + (size_t)r * L.per_run;
        const float* u = run + L.u[cur];
        if (j >= pl.tiles) {
            if constexpr (KRON) kron_rside<RM, RN>(sm, g, in, r, j - pl.tiles, u, u + N, run + L.kt);
            continue;
        }
        const int i0 = (j / ntj) * TM, j0 = (j % ntj) * TN;
        const Side sd = side_at(run + L.side[cur], da, db);
        for (int b = 0; b < g.nb; ++b) {
            const float* ut = run + L.ut[cur] + (size_t)b * M;
            apply_tile<RM, RN>(sm, g, sd, u + (size_t)b * M, u + N + (size_t)b * M, ut, ut + N, i0,
                               j0);
#pragma unroll 1
            for (int t = 0; t < NE; ++t) {
                const int o = threadIdx.x + t * NTHREADS, i = i0 + o / TN, jj = j0 + o % TN;
                if (o >= TM * TN || i >= da || jj >= db) continue;
                const int m = i * db + jj;
                const size_t e = (size_t)b * M + m;
                float h_re, h_im;
                side_terms(sm, o, u[e], u[N + e], in.diag[(size_t)r * M + m],
                           in.diag_lo[(size_t)r * M + m], h_re, h_im);
                if (KRON) {
                    run[L.q + e] = h_re;
                    run[L.q + N + e] = h_im;
                } else {
                    fwd_stage_end(run, L, in, g, tab, out, r, k, s, cur ^ 1, N, e,
                                  (size_t)b * M + (size_t)jj * da + i, h_re, h_im);
                }
            }
        }
    }
}

// K4's second phase of stage s with kron pairs: every term's C-side
// products at each tile, added to h in K1's order, then the stage's end.
template <int RM, int RN>
__device__ void fwd_phase_b(BlockSmem& sm, const In& in, const Geo& g, const Tab& tab,
                            const FwdLayout& L, const FwdOut& out, float* scratch,
                            const Plan& pl, int k, int s, int cur) {
    constexpr int TM = 16 * RM, TN = 8 * RN, NE = (TM * TN + NTHREADS - 1) / NTHREADS;
    const int da = g.da, db = g.db, M = da * db, ntj = cdiv(db, TN);
    const size_t N = (size_t)g.nb * M;
    const size_t zoff0 = zk_at(g, tab.S, in.K, 0, k, s);
    for (int job = blockIdx.x; job < g.R * pl.tiles; job += gridDim.x) {
        const int r = job / pl.tiles, j = job % pl.tiles;
        float* run = scratch + (size_t)r * L.per_run;
        const int i0 = (j / ntj) * TM, j0 = (j % ntj) * TN;
        for (int b = 0; b < g.nb; ++b) {
            float h_re[2] = {}, h_im[2] = {};
#pragma unroll 1
            for (int t = 0; t < NE; ++t) {
                const int o = threadIdx.x + t * NTHREADS, i = i0 + o / TN, jj = j0 + o % TN;
                if (o >= TM * TN || i >= da || jj >= db) continue;
                const size_t e = (size_t)b * M + (size_t)i * db + jj;
                h_re[t] = run[L.q + e];
                h_im[t] = run[L.q + N + e];
            }
            kron_cside<RM, RN>(sm, g, in, r, run + L.kt, b, i0, j0,
                               zoff0 + (size_t)r * g.n_steps * tab.S * in.K, h_re, h_im,
                               nullptr, nullptr, nullptr);
#pragma unroll 1
            for (int t = 0; t < NE; ++t) {
                const int o = threadIdx.x + t * NTHREADS, i = i0 + o / TN, jj = j0 + o % TN;
                if (o >= TM * TN || i >= da || jj >= db) continue;
                const size_t e = (size_t)b * M + (size_t)i * db + jj;
                fwd_stage_end(run, L, in, g, tab, out, r, k, s, cur ^ 1, N, e,
                              (size_t)b * M + (size_t)jj * da + i, h_re[t], h_im[t]);
            }
        }
    }
}

template <bool KRON>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_fwd_ckpt_kernel(In in, FwdOut out, float* scratch, Barrier bar, Geo g, Tab tab, Plan pl) {
    BlockSmem& sm = *reinterpret_cast<BlockSmem*>(smem_base());
    const int S = tab.S;
    const size_t N = (size_t)g.nb * g.da * g.db, RN = (size_t)g.R * N;
    const FwdLayout L = fwd_layout(S, g.nb, g.da, g.db, in.K);
    unsigned passed = 0;

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
        run[L.u[0] + e] = x;
        run[L.u[0] + N + e] = y;
        const size_t m = e % ((size_t)g.da * g.db), eT = e - m + (m % g.db) * g.da + m / g.db;
        run[L.ut[0] + eT] = x;
        run[L.ut[0] + N + eT] = y;
    }
    assemble_all(in, g, S, 0, 0, scratch, L.per_run, L.side[0]);
    grid_sync(bar, passed);

    int cur = 0;  // which stage-vector and side buffers the stage reads
    for (int k = 0; k < g.n_steps; ++k) {
        for (int s = 0; s < S; ++s) {
            if (pl.rm == 2) fwd_phase_a<KRON, 2, 2>(sm, in, g, tab, L, out, scratch, pl, k, s, cur);
            else fwd_phase_a<KRON, 1, 1>(sm, in, g, tab, L, out, scratch, pl, k, s, cur);
            // the next stage's sides, into the other buffer
            if (s + 1 < S) assemble_all(in, g, S, k, s + 1, scratch, L.per_run, L.side[cur ^ 1]);
            else if (k + 1 < g.n_steps) assemble_all(in, g, S, k + 1, 0, scratch, L.per_run, L.side[cur ^ 1]);
            grid_sync(bar, passed);
            if constexpr (KRON) {
                if (pl.rm == 2) fwd_phase_b<2, 2>(sm, in, g, tab, L, out, scratch, pl, k, s, cur);
                else fwd_phase_b<1, 1>(sm, in, g, tab, L, out, scratch, pl, k, s, cur);
                grid_sync(bar, passed);
            }
            cur ^= 1;
        }
    }
}

// ---------------------------------------------------------------------------
// K5: adjoint over the reversed steps from the stored start states
// ---------------------------------------------------------------------------
struct BwdLayout {  // float offsets inside one run's scratch (32 bits, as FwdLayout)
    unsigned l;       // costate (re N, im N)
    unsigned us;      // stage inputs, S x 2N (stage 0 is the stored start state, read in place)
    unsigned fk;      // forward stage derivatives, S x 2N (S - 1 used)
    unsigned ws;      // transpose products w_s, S x 2N (w_0 stays in registers)
    unsigned gv[2];   // the stage cotangent being applied, and the next one
    unsigned ust;     // stage inputs transposed (state b's (j, i) at b*da*db + j*da + i), S x 2N;
                      // stage 0's (the stored start state) written by the first recompute
    unsigned gvt[2];  // gv transposed
    unsigned q;       // kron pairs: h's side and diagonal terms
    unsigned sides;   // S + 1 sides: stage s at s, stage 0 of odd steps at S
    unsigned dacc;    // dbar accumulator (da, db)
    unsigned zp;      // outer-product partials, S x n_out x zrow (room for 2 MAX_PARTS)
    unsigned kt;      // kron R-side products, 4 K N
    unsigned kf[2];   // the cotangent fields B1, B2, D1, D2 of gv[.], 4 K N each
    unsigned kmp;     // B1 C, D1 C, u_x C, u_y C, R u_x, R u_y, R B2, R D2, 8 K N
    unsigned zkp;     // za / zb partials, S x n_tiles x K x 2
    unsigned side_sz;
    size_t per_run;
    int n_out, n_tiles;  // room for the partials of the smallest tile, which has the most jobs
};

__host__ __device__ inline BwdLayout bwd_layout(int S, int nb, int da, int db, int K) {
    const size_t M = (size_t)da * db, N = (size_t)nb * M;
    BwdLayout L;
    L.n_out = dtiles(da, da, 1, 1) + dtiles(db, db, 1, 1);
    L.n_tiles = cdiv(da, 16) * cdiv(db, 8);
    L.side_sz = side_floats(da, db);
    L.l = 0;
    L.us = 2 * N;
    L.fk = L.us + 2 * (size_t)S * N;
    L.ws = L.fk + 2 * (size_t)S * N;
    L.gv[0] = L.ws + 2 * (size_t)S * N;
    L.gv[1] = L.gv[0] + 2 * N;
    L.ust = L.gv[1] + 2 * N;
    L.gvt[0] = L.ust + 2 * (size_t)S * N;
    L.gvt[1] = L.gvt[0] + 2 * N;
    L.q = L.gvt[1] + 2 * N;
    L.sides = L.q + 2 * N;
    L.dacc = L.sides + (size_t)(S + 1) * L.side_sz;
    L.zp = L.dacc + M;
    L.kt = L.zp + (size_t)S * L.n_out * 2 * MAX_PARTS;
    L.kf[0] = L.kt + 4 * (size_t)K * N;
    L.kf[1] = L.kf[0] + 4 * (size_t)K * N;
    L.kmp = L.kf[1] + 4 * (size_t)K * N;
    L.zkp = L.kmp + 8 * (size_t)K * N;
    // the same sum in 64 bits (the launch checks it against 2^32)
    L.per_run = (size_t)(8 * S + 12) * N + (size_t)(S + 1) * side_floats(da, db) + M
                + (size_t)S * L.n_out * 2 * MAX_PARTS + 20 * (size_t)K * N + (size_t)S * L.n_tiles * K * 2;
    return L;
}

struct BwdOut {
    float *lam0_re, *lam0_im, *zbar, *dbar;
};

// Everything of one K5 phase that a job or an element needs.
struct BwdCtx {
    const In& in;
    const Geo& g;
    const Tab& tab;
    const BwdLayout& L;
    const BwdOut& out;
    float* scratch;
    const Plan& pl;
    int k, s, gsel;
};

__device__ __forceinline__ size_t side_index(int S, int k, int s) {
    return (s == 0 && (k & 1)) ? S : s;
}

// the stage input u_s of run r at step k: stage 0 is the step's start
// state, stored[k - 1] (psi0 at k = 0), read in place
__device__ __forceinline__ void stage_input(const BwdCtx& c, int r, int s, const float*& ure,
                                            const float*& uim) {
    const size_t N = (size_t)c.g.nb * c.g.da * c.g.db;
    if (s) {
        ure = c.scratch + (size_t)r * c.L.per_run + c.L.us + 2 * (size_t)s * N;
        uim = ure + N;
    } else if (c.k) {
        ure = c.in.st_re + ((size_t)r * c.g.n_steps + c.k - 1) * N;
        uim = c.in.st_im + ((size_t)r * c.g.n_steps + c.k - 1) * N;
    } else {
        ure = c.in.psi_re + (size_t)r * N;
        uim = c.in.psi_im + (size_t)r * N;
    }
}

// u_s transposed (stage 0: once the first recompute has written it)
__device__ __forceinline__ const float* stage_input_t(const BwdCtx& c, int r, int s) {
    const size_t N = (size_t)c.g.nb * c.g.da * c.g.db;
    return c.scratch + (size_t)r * c.L.per_run + c.L.ust + 2 * (size_t)s * N;
}

// the kron cotangent fields B1, B2, D1, D2 of g = (gx, gy) at element e,
// with the streams at zo
__device__ __forceinline__ void kron_fields(const In& in, float* kf, size_t N, size_t e, size_t zo,
                                            float gx, float gy) {
    for (int j = 0; j < in.K; ++j) {
        const float za = in.zk[0][zo + j] + in.zk[2][zo + j];
        const float zb = in.zk[1][zo + j] + in.zk[3][zo + j];
        float* f = kf + (size_t)4 * j * N + e;
        f[0] = zb * gx - za * gy;
        f[N] = -zb * gx - za * gy;
        f[2 * N] = za * gx + zb * gy;
        f[3 * N] = za * gx - zb * gy;
    }
}

// g_(S-1) of step k from the costate (lx, ly) at element e, into gv[dst]
// (with kron pairs also its fields)
template <bool KRON>
__device__ __forceinline__ void last_stage_cotangent(const BwdCtx& c, float* run, int r, int k,
                                                     int dst, size_t N, size_t e, size_t eT,
                                                     float lx, float ly) {
    const int S = c.tab.S;
    float gx = 0.f, gy = 0.f;
    if (c.tab.bnz[S - 1]) {
        const float bhl = c.in.hb_hi[k * S + S - 1] + c.in.hb_lo[k * S + S - 1];
        gx = bhl * lx;
        gy = bhl * ly;
    }
    run[c.L.gv[dst] + e] = gx;
    run[c.L.gv[dst] + N + e] = gy;
    run[c.L.gvt[dst] + eT] = gx;
    run[c.L.gvt[dst] + N + eT] = gy;
    if constexpr (KRON)
        kron_fields(c.in, run + c.L.kf[dst], N, e, zk_at(c.g, S, c.in.K, r, k, S - 1), gx, gy);
}

// The end of forward recompute stage s at element e (eT: its index
// transposed; K1's order): the stage derivative, the next stage input (and
// at the first stage the start state, transposed), and at the last
// recomputed stage the dbar term of g_(S-1), which was formed before its
// stage input.
__device__ __forceinline__ void bwd_fwd_end(const BwdCtx& c, float* run, int r, size_t N, size_t e,
                                            size_t eT, float h_re, float h_im, float& dac) {
    const int s = c.s;
    const float h = c.in.hs[c.k];
    float* FK = run + c.L.fk;
    FK[2 * s * N + e] = h_im;
    FK[2 * s * N + N + e] = -h_re;
    float kx[MAX_S], ky[MAX_S];
    load_stages(FK, N, e, s, s, h_im, -h_re, kx, ky);
    const float *x0re, *x0im;
    stage_input(c, r, 0, x0re, x0im);
    float xs = x0re[e], ys = x0im[e];
    if (s == 0) {
        run[c.L.ust + eT] = xs;
        run[c.L.ust + N + eT] = ys;
    }
    stage_input_sum(c.tab, s, h, kx, ky, xs, ys);
    run[c.L.us + 2 * (s + 1) * N + e] = xs;
    run[c.L.us + 2 * (s + 1) * N + N + e] = ys;
    run[c.L.ust + 2 * (s + 1) * N + eT] = xs;
    run[c.L.ust + 2 * (s + 1) * N + N + eT] = ys;
    if (s + 2 == c.tab.S) {
        const float* gv = run + c.L.gv[c.gsel];
        dac = dac + (gv[e] * ys - gv[N + e] * xs);
    }
}

// The end of the transpose application of g_s at element e (eT: its index
// transposed): w_s, then the next stage cotangent g_(s-1) (the h*b weight on
// the costate and the transpose recursion over w_s .. w_(S-1), in stage
// order) with its dbar term and (kron pairs) fields; after stage 0 the
// costate update, and either the next step's costate and g_(S-1) or lam0.
template <bool KRON>
__device__ __forceinline__ void bwd_rev_end(const BwdCtx& c, float* run, int r, size_t N,
                                            size_t e, size_t eT, float h_re, float h_im,
                                            float& dac) {
    const int S = c.tab.S, s = c.s, k = c.k, nxt = c.gsel ^ 1;
    const float wx = -1.f * h_im, wy = h_re;  // F^T = -F: sign -1
    float* WS = run + c.L.ws;
    const float* lam = run + c.L.l;
    const float lx0 = lam[e], ly0 = lam[N + e];
    if (s > 0) {
        WS[2 * s * N + e] = wx;
        WS[2 * s * N + N + e] = wy;
        const float h = c.in.hs[k];
        float gx = 0.f, gy = 0.f;
        if (c.tab.bnz[s - 1]) {
            const float bhl = c.in.hb_hi[k * S + s - 1] + c.in.hb_lo[k * S + s - 1];
            gx = bhl * lx0;
            gy = bhl * ly0;
        }
        for (int rr = s; rr < S; ++rr) {
            const float a = c.tab.a[rr][s - 1];
            if (a != 0.f) {
                const float cc = a * h;
                gx = gx + cc * (rr == s ? wx : WS[2 * rr * N + e]);
                gy = gy + cc * (rr == s ? wy : WS[2 * rr * N + N + e]);
            }
        }
        run[c.L.gv[nxt] + e] = gx;
        run[c.L.gv[nxt] + N + e] = gy;
        run[c.L.gvt[nxt] + eT] = gx;
        run[c.L.gvt[nxt] + N + eT] = gy;
        const float *ure, *uim;
        stage_input(c, r, s - 1, ure, uim);
        dac = dac + (gx * uim[e] - gy * ure[e]);
        if constexpr (KRON)
            kron_fields(c.in, run + c.L.kf[nxt], N, e, zk_at(c.g, S, c.in.K, r, k, s - 1), gx, gy);
        return;
    }
    float lx = lx0 + wx, ly = ly0 + wy;
    for (int s2 = 1; s2 < S; ++s2) {
        lx = lx + WS[2 * s2 * N + e];
        ly = ly + WS[2 * s2 * N + N + e];
    }
    if (k == 0) {
        c.out.lam0_re[(size_t)r * N + e] = lx;
        c.out.lam0_im[(size_t)r * N + e] = ly;
        return;
    }
    const size_t o = ((size_t)r * c.g.n_steps + k - 1) * N + e;
    lx = lx + c.in.lam_re[o];
    ly = ly + c.in.lam_im[o];
    run[c.L.l + e] = lx;
    run[c.L.l + N + e] = ly;
    last_stage_cotangent<KRON>(c, run, r, k - 1, nxt, N, e, eT, lx, ly);
}

// One outer-product job of stage s: a double tile of
//   W = sum_b g_x u_y^T - g_y u_x^T,  V = sum_b g_x u_x^T + g_y u_y^T  (da, da; jobs < n_or)
//   Wc = sum_b u_y^T g_x - u_x^T g_y,  Vc = sum_b u_x^T g_x + u_y^T g_y  (db, db)
// (K2's forms), reduced against the part stacks to (<Sym_p, W>, <Asym_p, V>)_p
// or (<Sym_p, Wc>, -<Asym_p, Vc>)_p in one row of zrow(g) at zp.
template <int RM, int RN>
__device__ __noinline__ void outer_job(BlockSmem& sm, const BwdCtx& c, int r, int jj, float* zp) {
    constexpr int TM = 16 * RM, TN = 8 * RN;
    const Geo& g = c.g;
    const int da = g.da, db = g.db, n_or = dtiles(da, da, RM, RN), grp = threadIdx.x / GTHREADS;
    const size_t M = (size_t)da * db;
    const bool rows = jj < n_or;
    const int t = rows ? jj : jj - n_or, n = rows ? da : db, ntj = cdiv(n, TN);
    const int i0 = (t / ntj) * 2 * TM + grp * TM, j0 = (t % ntj) * TN;
    const float* gre = c.scratch + (size_t)r * c.L.per_run + c.L.gv[c.gsel];
    const float* gim = gre + (size_t)g.nb * M;
    const float* gtre = c.scratch + (size_t)r * c.L.per_run + c.L.gvt[c.gsel];
    const float* gtim = gtre + (size_t)g.nb * M;
    const float *ure, *uim;
    stage_input(c, r, c.s, ure, uim);
    const float* utre = stage_input_t(c, r, c.s);
    const float* utim = utre + (size_t)g.nb * M;
    float w[RM][RN] = {}, v[RM][RN] = {};
    for (int b = 0; b < g.nb; ++b) {
        const size_t ob = (size_t)b * M;
        float p[4][RM][RN];
        if (rows) {  // A(i, kk) = g_b[i, kk], B(kk, j) = u_b[j, kk], from the transposes
            const Src A[2] = {{gtre + ob, da, 1}, {gtim + ob, da, 1}};
            const Src B[2] = {{utre + ob, da, 1}, {utim + ob, da, 1}};
            group_mma<CPLX, RM, RN>(sm.g[grp], grp, A, B, da, da, db, i0, j0, p);
        } else {  // A(i, kk) = u_b[kk, i], B(kk, j) = g_b[kk, j]
            const Src A[2] = {{ure + ob, db, 1}, {uim + ob, db, 1}};
            const Src B[2] = {{gre + ob, db, 1}, {gim + ob, db, 1}};
            group_mma<CPLX, RM, RN>(sm.g[grp], grp, A, B, db, db, da, i0, j0, p);
        }
#pragma unroll
        for (int r2 = 0; r2 < RM; ++r2)
#pragma unroll
            for (int c2 = 0; c2 < RN; ++c2) {
                w[r2][c2] = w[r2][c2] + (rows ? p[3][r2][c2] - p[2][r2][c2]
                                              : p[2][r2][c2] - p[3][r2][c2]);
                v[r2][c2] = v[r2][c2] + (p[0][r2][c2] + p[1][r2][c2]);
            }
    }
    // the parts in chunks of P_CHUNK, each reduced to its own ZW columns of
    // the job's row (one chunk at most P_CHUNK parts)
    const int n_parts = rows ? g.pr : g.pc;
    const size_t nn = (size_t)n * n;
    for (int c0 = 0; c0 < n_parts; c0 += P_CHUNK) {
        // the chunk's parts: np of them, from the stacks at part c0
        const int np = n_parts - c0;
        const float *rsym = c.in.rsym + c0 * nn, *rasym = c.in.rasym + c0 * nn;
        const float *csym = c.in.csym + c0 * nn, *casym = c.in.casym + c0 * nn;
        float acc[ZW] = {};
#pragma unroll
        for (int r2 = 0; r2 < RM; ++r2)
#pragma unroll
            for (int c2 = 0; c2 < RN; ++c2) {
                const int i = i0 + tile_row<RM, RN>(r2), j = j0 + tile_col<RM, RN>(c2);
                if (i >= n || j >= n) continue;
                const size_t qd = (size_t)i * n + j;
#pragma unroll
                for (int pp = 0; pp < P_CHUNK; ++pp) {
                    if (rows && pp < np) {
                        acc[2 * pp] = acc[2 * pp] + rsym[pp * nn + qd] * w[r2][c2];
                        acc[2 * pp + 1] = acc[2 * pp + 1] + rasym[pp * nn + qd] * v[r2][c2];
                    }
                    if (!rows && pp < np) {
                        acc[2 * pp] = acc[2 * pp] + csym[pp * nn + qd] * w[r2][c2];
                        acc[2 * pp + 1] = acc[2 * pp + 1] - casym[pp * nn + qd] * v[r2][c2];
                    }
                }
            }
        block_reduce(sm, acc, 2 * np < ZW ? 2 * np : ZW, zp + (size_t)jj * zrow(g) + 2 * c0,
                     false);
    }
}

// One job of the part-matrix cotangents' first products (stage s): over
// (term, kind, state b, double tile), from g's fields f = (B1, B2, D1, D2)
// and the stage input u, into kmp (per term B1 C, D1 C, u_x C, u_y C,
// R u_x, R u_y, R B2, R D2).
template <int RM, int RN>
__device__ __noinline__ void mat_first(BlockSmem& sm, const BwdCtx& c, int r, int jj) {
    constexpr int TM = 16 * RM, TN = 8 * RN;
    const Geo& g = c.g;
    const int da = g.da, db = g.db, ntj = cdiv(db, TN), dt = dtiles(da, db, RM, RN);
    const size_t M = (size_t)da * db, N = g.nb * M;
    const int per = g.nb * dt, term = jj / (4 * per), w = (jj / per) % 4, rem = jj % per;
    const int b = rem / dt, t = rem % dt, grp = threadIdx.x / GTHREADS;
    const int i0 = (t / ntj) * 2 * TM + grp * TM, j0 = (t % ntj) * TN;
    float* run = c.scratch + (size_t)r * c.L.per_run;
    const float* f = run + c.L.kf[c.gsel] + (size_t)4 * term * N + b * M;
    const float *ure, *uim;
    stage_input(c, r, c.s, ure, uim);
    const float *ux = ure + b * M, *uy = uim + b * M;
    const float* C = c.in.kc + ((size_t)r * c.in.K + term) * db * db;
    const float* R = c.in.kr + ((size_t)r * c.in.K + term) * da * da;
    const Src Cm = {C, db, 1}, Rm = {R, da, 0};
    float p[2][RM][RN];
    if (w < 2) {
        const Src A[2] = {{w ? ux : f, db, 0}, {w ? uy : f + 2 * N, db, 0}};
        const Src B[2] = {Cm, Cm};
        group_mma<PAIR, RM, RN>(sm.g[grp], grp, A, B, da, db, db, i0, j0, p);
    } else {
        const Src A[2] = {Rm, Rm};
        const Src B[2] = {{w == 2 ? ux : f + N, db, 1}, {w == 2 ? uy : f + 3 * N, db, 1}};
        group_mma<PAIR, RM, RN>(sm.g[grp], grp, A, B, da, db, da, i0, j0, p);
    }
    float* o = run + c.L.kmp + (size_t)(8 * term + 2 * w) * N + b * M;
    store_pair<RM, RN>(p, o, o + N, da, db, i0, j0);
}

// One job of the part-matrix cotangents' second products: a double tile of
//   krbar_k += B1 C u_x^T + (u_x C) B2^T + D1 C u_y^T + (u_y C) D2^T     (jobs < n_or)
//   kcbar_k += B1^T (R u_x) + u_x^T (R B2) + D1^T (R u_y) + u_y^T (R D2)
// in that order, state after state (_kron_matrix_cotangents); the job owns
// its elements in this phase.
template <int RM, int RN>
__device__ __noinline__ void mat_second(BlockSmem& sm, const BwdCtx& c, int r, int jj) {
    constexpr int TM = 16 * RM, TN = 8 * RN;
    const Geo& g = c.g;
    const int da = g.da, db = g.db, n_or = dtiles(da, da, RM, RN);
    const int n_oc = dtiles(db, db, RM, RN), grp = threadIdx.x / GTHREADS;
    const size_t M = (size_t)da * db, N = g.nb * M;
    const int term = jj / (n_or + n_oc), tile = jj % (n_or + n_oc);
    const bool rows = tile < n_or;
    const int n = rows ? da : db, tl = rows ? tile : tile - n_or, ntj = cdiv(n, TN);
    const int i0 = (tl / ntj) * 2 * TM + grp * TM, j0 = (tl % ntj) * TN;
    float* dst = rows ? c.in.krbar + ((size_t)r * c.in.K + term) * da * da
                      : c.in.kcbar + ((size_t)r * c.in.K + term) * db * db;
    float acc[RM][RN];
#pragma unroll
    for (int r2 = 0; r2 < RM; ++r2)
#pragma unroll
        for (int c2 = 0; c2 < RN; ++c2) {
            const int i = i0 + tile_row<RM, RN>(r2), j = j0 + tile_col<RM, RN>(c2);
            acc[r2][c2] = (i < n && j < n) ? dst[(size_t)i * n + j] : 0.f;
        }
    float* run = c.scratch + (size_t)r * c.L.per_run;
    const float *ure, *uim;
    stage_input(c, r, c.s, ure, uim);
    for (int b = 0; b < g.nb; ++b) {
        const float* f = run + c.L.kf[c.gsel] + (size_t)4 * term * N + b * M;
        const float *ux = ure + b * M, *uy = uim + b * M;
        const float* mp = run + c.L.kmp + (size_t)8 * term * N + b * M;
        float p[4][RM][RN];
        if (rows) {  // (da, db) x (db, da)
            const Src A[4] = {{mp, db, 0}, {mp + 2 * N, db, 0}, {mp + N, db, 0}, {mp + 3 * N, db, 0}};
            const Src B[4] = {{ux, db, 0}, {f + N, db, 0}, {uy, db, 0}, {f + 3 * N, db, 0}};
            group_mma<QUAD, RM, RN>(sm.g[grp], grp, A, B, da, da, db, i0, j0, p);
        } else {  // (db, da) x (da, db)
            const Src A[4] = {{f, db, 1}, {ux, db, 1}, {f + 2 * N, db, 1}, {uy, db, 1}};
            const Src B[4] = {{mp + 4 * N, db, 1}, {mp + 6 * N, db, 1}, {mp + 5 * N, db, 1},
                              {mp + 7 * N, db, 1}};
            group_mma<QUAD, RM, RN>(sm.g[grp], grp, A, B, db, db, da, i0, j0, p);
        }
#pragma unroll
        for (int r2 = 0; r2 < RM; ++r2)
#pragma unroll
            for (int c2 = 0; c2 < RN; ++c2)
                acc[r2][c2] = (((acc[r2][c2] + p[0][r2][c2]) + p[1][r2][c2]) + p[2][r2][c2])
                              + p[3][r2][c2];
    }
#pragma unroll
    for (int r2 = 0; r2 < RM; ++r2)
#pragma unroll
        for (int c2 = 0; c2 < RN; ++c2) {
            const int i = i0 + tile_row<RM, RN>(r2), j = j0 + tile_col<RM, RN>(c2);
            if (i < n && j < n) dst[(size_t)i * n + j] = acc[r2][c2];
        }
}

// Phase A of an application in K5: the side products of v at every tile
// (v = u_s in the forward recompute, g_s in the transpose recursion) with
// their epilogue (the stage's end, or with kron pairs h's side and diagonal
// terms into q), the R-side kron jobs on v; in the transpose recursion also
// the part-matrix cotangents' first products and the stream cotangents.
template <bool KRON, int RM, int RN>
__device__ __noinline__ void bwd_phase_a(BlockSmem& sm, const BwdCtx& c, bool rev) {
    constexpr int TM = 16 * RM, TN = 8 * RN, NE = (TM * TN + NTHREADS - 1) / NTHREADS;
    const Geo& g = c.g;
    const int da = g.da, db = g.db, M = da * db, ntj = cdiv(db, TN);
    const size_t N = (size_t)g.nb * M;
    const int dt = dtiles(da, db, RM, RN);
    const int n_rside = KRON ? 2 * c.in.K * g.nb * dt : 0;
    const int n_mat = KRON && rev ? 4 * c.in.K * g.nb * dt : 0;
    const int n_out = rev ? dtiles(da, da, RM, RN) + dtiles(db, db, RM, RN) : 0;
    const int per = c.pl.tiles + n_rside + n_mat + n_out;
    for (int job = blockIdx.x; job < g.R * per; job += gridDim.x) {
        const int r = job / per;
        int j = job % per;
        float* run = c.scratch + (size_t)r * c.L.per_run;
        const float *vre, *vim, *vt = nullptr;  // vt: v transposed, where it exists yet
        if (rev) {
            vre = run + c.L.gv[c.gsel];
            vim = vre + N;
            vt = run + c.L.gvt[c.gsel];
        } else {
            stage_input(c, r, c.s, vre, vim);
            if (c.s) vt = stage_input_t(c, r, c.s);
        }
        if (j < c.pl.tiles) {
            const int i0 = (j / ntj) * TM, j0 = (j % ntj) * TN;
            const Side sd = side_at(run + c.L.sides + side_index(c.tab.S, c.k, c.s) * c.L.side_sz, da, db);
            float dac[2] = {};
            for (int b = 0; b < g.nb; ++b) {
                apply_tile<RM, RN>(sm, g, sd, vre + (size_t)b * M, vim + (size_t)b * M,
                                   vt ? vt + (size_t)b * M : nullptr,
                                   vt ? vt + N + (size_t)b * M : nullptr, i0, j0);
#pragma unroll 1
                for (int t = 0; t < NE; ++t) {
                    const int o = threadIdx.x + t * NTHREADS, i = i0 + o / TN, jj = j0 + o % TN;
                    if (o >= TM * TN || i >= da || jj >= db) continue;
                    const int m = i * db + jj;
                    const size_t e = (size_t)b * M + m;
                    float h_re, h_im;
                    side_terms(sm, o, vre[e], vim[e], c.in.diag[(size_t)r * M + m],
                               c.in.diag_lo[(size_t)r * M + m], h_re, h_im);
                    if (KRON) {
                        run[c.L.q + e] = h_re;
                        run[c.L.q + N + e] = h_im;
                    } else if (rev) {
                        bwd_rev_end<KRON>(c, run, r, N, e, (size_t)b * M + (size_t)jj * da + i,
                                          h_re, h_im, dac[t]);
                    } else {
                        bwd_fwd_end(c, run, r, N, e, (size_t)b * M + (size_t)jj * da + i, h_re,
                                    h_im, dac[t]);
                    }
                }
            }
            if (!KRON && (rev ? c.s > 0 : c.s + 2 == c.tab.S)) {
#pragma unroll 1
                for (int t = 0; t < NE; ++t) {
                    const int o = threadIdx.x + t * NTHREADS, i = i0 + o / TN, jj = j0 + o % TN;
                    if (o < TM * TN && i < da && jj < db) run[c.L.dacc + i * db + jj] += dac[t];
                }
            }
            continue;
        }
        j -= c.pl.tiles;
        if constexpr (KRON) {
            if (j < n_rside) {
                kron_rside<RM, RN>(sm, g, c.in, r, j, vre, vim, run + c.L.kt);
                continue;
            }
            j -= n_rside;
            if (j < n_mat) {
                mat_first<RM, RN>(sm, c, r, j);
                continue;
            }
            j -= n_mat;
        }
        outer_job<RM, RN>(sm, c, r, j, run + c.L.zp + (size_t)c.s * c.L.n_out * zrow(g));
    }
}

// The stage's end in K5's kron path, out of line: the C-side jobs take the
// registers, and the kernel keeps its own few values through the calls.
__device__ __noinline__ void kron_stage_end(const BwdCtx& c, bool rev, float* run, int r, size_t N,
                                            size_t e, size_t eT, float h_re, float h_im,
                                            float& dac) {
    if (rev) bwd_rev_end<true>(c, run, r, N, e, eT, h_re, h_im, dac);
    else bwd_fwd_end(c, run, r, N, e, eT, h_re, h_im, dac);
}

// Phase B of an application in K5 with kron pairs: every term's C-side
// products at each tile, added to h, then the stage's end (in the transpose
// recursion with the za / zb partials); in the transpose recursion also
// the part-matrix cotangents' second products.
template <int RM, int RN>
__device__ __noinline__ void bwd_phase_b(BlockSmem& sm, const BwdCtx& c, bool rev) {
    constexpr int TM = 16 * RM, TN = 8 * RN, NE = (TM * TN + NTHREADS - 1) / NTHREADS;
    const Geo& g = c.g;
    const int da = g.da, db = g.db, M = da * db, ntj = cdiv(db, TN), K = c.in.K;
    const size_t N = (size_t)g.nb * M;
    const int n_mat = rev ? K * (dtiles(da, da, RM, RN) + dtiles(db, db, RM, RN)) : 0;
    const int per = c.pl.tiles + n_mat;
    for (int job = blockIdx.x; job < g.R * per; job += gridDim.x) {
        const int r = job / per, j = job % per;
        if (j >= c.pl.tiles) {
            mat_second<RM, RN>(sm, c, r, j - c.pl.tiles);
            continue;
        }
        float* run = c.scratch + (size_t)r * c.L.per_run;
        const int i0 = (j / ntj) * TM, j0 = (j % ntj) * TN;
        const float *ure, *uim;
        stage_input(c, r, c.s, ure, uim);
        float* zp = rev ? run + c.L.zkp + ((size_t)c.s * c.L.n_tiles + j) * K * 2 : nullptr;
        float dac[2] = {};
        for (int b = 0; b < g.nb; ++b) {
            float h_re[2] = {}, h_im[2] = {};
#pragma unroll 1
            for (int t = 0; t < NE; ++t) {
                const int o = threadIdx.x + t * NTHREADS, i = i0 + o / TN, jj = j0 + o % TN;
                if (o >= TM * TN || i >= da || jj >= db) continue;
                const size_t e = (size_t)b * M + (size_t)i * db + jj;
                h_re[t] = run[c.L.q + e];
                h_im[t] = run[c.L.q + N + e];
            }
            kron_cside<RM, RN>(sm, g, c.in, r, run + c.L.kt, b, i0, j0,
                               zk_at(g, c.tab.S, K, r, c.k, c.s), h_re, h_im, ure, uim, zp);
#pragma unroll 1
            for (int t = 0; t < NE; ++t) {
                const int o = threadIdx.x + t * NTHREADS, i = i0 + o / TN, jj = j0 + o % TN;
                if (o >= TM * TN || i >= da || jj >= db) continue;
                const size_t e = (size_t)b * M + (size_t)i * db + jj;
                kron_stage_end(c, rev, run, r, N, e, (size_t)b * M + (size_t)jj * da + i, h_re[t],
                               h_im[t], dac[t]);
            }
        }
        if (rev ? c.s > 0 : c.s + 2 == c.tab.S) {
#pragma unroll 1
            for (int t = 0; t < NE; ++t) {
                const int o = threadIdx.x + t * NTHREADS, i = i0 + o / TN, jj = j0 + o % TN;
                if (o < TM * TN && i < da && jj < db) run[c.L.dacc + i * db + jj] += dac[t];
            }
        }
    }
}

// zbar[r, kk, s, :] for every run and stage from the jobs' partials, in a
// fixed order: the parts' columns, then each kron pair's (za_bar, zb_bar).
__device__ __noinline__ void reduce_zbar(const Geo& g, int S, int K, const BwdLayout& L,
                                         const Plan& pl,
                            const float* scratch, float* zbar, int kk) {
    const int nrow = 2 * g.pr + 2 * g.pc + 2 * K;
    const int n_or = dtiles(g.da, g.da, pl.rm, pl.rn), n_oc = dtiles(g.db, g.db, pl.rm, pl.rn);
    for (size_t idx = gtid(); idx < (size_t)g.R * S * nrow; idx += gsize()) {
        const int r = (int)(idx / ((size_t)S * nrow));
        const int rem = (int)(idx - (size_t)r * S * nrow);
        const int s = rem / nrow, q = rem % nrow;
        const float* run = scratch + (size_t)r * L.per_run;
        const int zr = zrow(g);
        const float* zp = run + L.zp + (size_t)s * L.n_out * zr;
        float v = 0.f;
        if (q < 2 * g.pr) {
            for (int t = 0; t < n_or; ++t) v += zp[(size_t)t * zr + q];
        } else if (q < 2 * g.pr + 2 * g.pc) {
            for (int t = 0; t < n_oc; ++t) v += zp[(size_t)(n_or + t) * zr + (q - 2 * g.pr)];
        } else {
            const int kq = q - 2 * g.pr - 2 * g.pc;
            const float* zk = run + L.zkp + (size_t)s * L.n_tiles * K * 2 + kq;
            for (int t = 0; t < pl.tiles; ++t) v += zk[(size_t)t * K * 2];
        }
        zbar[(((size_t)r * g.n_steps + kk) * S + s) * nrow + q] = v;
    }
}

// K5's start: the part-matrix cotangents and dbar at zero; the costate of
// the last step is its cotangent, and g_(S-1) follows from it.
template <bool KRON>
__device__ __noinline__ void bwd_init(const BwdCtx& c) {
    const In& in = c.in;
    const Geo& g = c.g;
    const BwdLayout& L = c.L;
    const int M = g.da * g.db, n = g.n_steps;
    const size_t N = (size_t)g.nb * M;
    if constexpr (KRON) {
        for (size_t idx = gtid(); idx < (size_t)g.R * in.K * g.da * g.da; idx += gsize())
            in.krbar[idx] = 0.f;
        for (size_t idx = gtid(); idx < (size_t)g.R * in.K * g.db * g.db; idx += gsize())
            in.kcbar[idx] = 0.f;
    }
    for (size_t idx = gtid(); idx < (size_t)g.R * N; idx += gsize()) {
        const int r = (int)(idx / N);
        const size_t e = idx - (size_t)r * N;
        float* run = c.scratch + (size_t)r * L.per_run;
        const size_t o = ((size_t)r * n + n - 1) * N + e;
        const float lx = 0.f + in.lam_re[o], ly = 0.f + in.lam_im[o];
        run[L.l + e] = lx;
        run[L.l + N + e] = ly;
        const size_t m = e % (size_t)M, eT = e - m + (m % g.db) * g.da + m / g.db;
        last_stage_cotangent<KRON>(c, run, r, n - 1, 0, N, e, eT, lx, ly);
    }
    for (size_t idx = gtid(); idx < (size_t)g.R * M; idx += gsize()) {
        const int r = (int)(idx / M), m = (int)(idx - (size_t)r * M);
        c.scratch[(size_t)r * L.per_run + L.dacc + m] = 0.f;
    }
}

template <bool KRON>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_bwd_ckpt_kernel(In in, BwdOut out, float* scratch, Barrier bar, Geo g, Tab tab, Plan pl) {
    BlockSmem& sm = *reinterpret_cast<BlockSmem*>(smem_base());
    const int S = tab.S, M = g.da * g.db, n = g.n_steps;
    const size_t RM = (size_t)g.R * M;
    const BwdLayout L = bwd_layout(S, g.nb, g.da, g.db, in.K);
    unsigned passed = 0;

    bwd_init<KRON>(BwdCtx{in, g, tab, L, out, scratch, pl, n - 1, S - 1, 0});
    assemble_all(in, g, S, n - 1, 0, scratch, L.per_run, L.sides + side_index(S, n - 1, 0) * L.side_sz);
    grid_sync(bar, passed);

    int gsel = 0;  // which of gv holds the stage cotangent being applied
    for (int k = n - 1; k >= 0; --k) {
        // forward stage recompute (the last stage's product is dead)
        for (int s = 0; s + 1 < S; ++s) {
            const BwdCtx c = {in, g, tab, L, out, scratch, pl, k, s, gsel};
            if (pl.rm == 2) bwd_phase_a<KRON, 2, 2>(sm, c, false);
            else bwd_phase_a<KRON, 1, 1>(sm, c, false);
            if (s == 0 && k + 1 < n) reduce_zbar(g, S, in.K, L, pl, scratch, out.zbar, k + 1);
            assemble_all(in, g, S, k, s + 1, scratch, L.per_run, L.sides + (s + 1) * L.side_sz);
            grid_sync(bar, passed);
            if constexpr (KRON) {
                if (pl.rm == 2) bwd_phase_b<2, 2>(sm, c, false);
                else bwd_phase_b<1, 1>(sm, c, false);
                grid_sync(bar, passed);
            }
        }
        // reversed transpose recursion with each stage's cotangent work
        for (int s = S - 1; s >= 0; --s) {
            const BwdCtx c = {in, g, tab, L, out, scratch, pl, k, s, gsel};
            if (pl.rm == 2) bwd_phase_a<KRON, 2, 2>(sm, c, true);
            else bwd_phase_a<KRON, 1, 1>(sm, c, true);
            if (s == S - 1 && k > 0)
                assemble_all(in, g, S, k - 1, 0, scratch, L.per_run,
                             L.sides + side_index(S, k - 1, 0) * L.side_sz);
            grid_sync(bar, passed);
            if constexpr (KRON) {
                if (pl.rm == 2) bwd_phase_b<2, 2>(sm, c, true);
                else bwd_phase_b<1, 1>(sm, c, true);
                grid_sync(bar, passed);
            }
            gsel ^= 1;
        }
    }
    // the outputs
    for (size_t idx = gtid(); idx < RM; idx += gsize()) {
        const int r = (int)(idx / M), m = (int)(idx - (size_t)r * M);
        out.dbar[idx] = scratch[(size_t)r * L.per_run + L.dacc + m];
    }
    reduce_zbar(g, S, in.K, L, pl, scratch, out.zbar, 0);
}

// ---------------------------------------------------------------------------
// C interface (ctypes).  Every function returns 0 on success, a negative
// code for what the kernel does not take (-1 tableau, -2 parts, -3 no
// cooperative launch on this device, -4 kron pairs, -7 a block does not fit
// an SM, -8 a run's scratch past 2^32 floats), or the cudaError_t of the
// launch.
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

// the kernel instantiation a launch takes: the kron-pair branch is its own
static const void* kernel_of(int bwd, int K) {
    if (bwd)
        return K ? (const void*)fused_bwd_ckpt_kernel<true> : (const void*)fused_bwd_ckpt_kernel<false>;
    return K ? (const void*)fused_fwd_ckpt_kernel<true> : (const void*)fused_fwd_ckpt_kernel<false>;
}

// The plan on the current device: one block per SM, at most as many as the
// largest phase has jobs.
static int device_plan(int bwd, int R, int nb, int da, int db, int K, int S, Plan* plan,
                       int* blocks, int* sms) {
    int dev = 0, coop = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return -3;
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const void* fn = kernel_of(bwd, K);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(BlockSmem));
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NTHREADS, sizeof(BlockSmem));
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return -7;
    *plan = make_plan(bwd, R, nb, da, db, K, S, *sms);
    *blocks = plan->jobs < *sms ? plan->jobs : *sms;
    if (*blocks < 1) *blocks = 1;
    return 0;
}

static int neg(int err) { return err > 0 ? -err : err; }

extern "C" int pdt_ckpt_blocks(int bwd, int R, int nb, int da, int db, int K) {
    Plan plan;
    int blocks = 0, sms = 0;
    const int err = device_plan(bwd, R, nb, da, db, K, MAX_S, &plan, &blocks, &sms);
    return err ? neg(err) : blocks;
}

// out: blocks, tile rows, tile columns, the largest phase's jobs, grid
// barriers per step, shared memory a block (bytes), the device's SMs
extern "C" int pdt_ckpt_plan(int bwd, int R, int nb, int da, int db, int K, int S, int* out) {
    Plan plan;
    int blocks = 0, sms = 0;
    const int err = device_plan(bwd, R, nb, da, db, K, S, &plan, &blocks, &sms);
    if (err) return neg(err);
    out[0] = blocks;
    out[1] = 16 * plan.rm;
    out[2] = 8 * plan.rn;
    out[3] = plan.jobs;
    out[4] = plan.per_step;
    out[5] = (int)sizeof(BlockSmem);
    out[6] = sms;
    return 0;
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
    if (pr > MAX_PARTS || pc > MAX_PARTS) return -2;
    if (K < 0 || K > MAX_K) return -4;
    if (fwd_layout(S, nb, da, db, K).per_run > 0xffffffffu) return -8;
    Plan plan;
    int blocks = 0, sms = 0;
    const int err = device_plan(0, R, nb, da, db, K, S, &plan, &blocks, &sms);
    if (err) return err;
    const In in = make_in(in_ptrs, kron_in, K, 0);
    const FwdOut out = {out_re, out_im, lo_re, lo_im};
    const Barrier b = {bar, bar + 1};
    const Geo g = {R, n_steps, nb, da, db, pr, pc};
    cudaError_t e = launch_grid(K ? fused_fwd_ckpt_kernel<true> : fused_fwd_ckpt_kernel<false>,
                                blocks, sizeof(BlockSmem), (cudaStream_t)stream, in, out, scratch,
                                b, g, tab, plan);
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
    if (pr > MAX_PARTS || pc > MAX_PARTS) return -2;
    if (K < 0 || K > MAX_K) return -4;
    if (bwd_layout(S, nb, da, db, K).per_run > 0xffffffffu) return -8;
    Plan plan;
    int blocks = 0, sms = 0;
    const int err = device_plan(1, R, nb, da, db, K, S, &plan, &blocks, &sms);
    if (err) return err;
    In in = make_in(in_ptrs, kron_in, K, 1);
    in.krbar = krbar;
    in.kcbar = kcbar;
    const BwdOut out = {lam0_re, lam0_im, zbar, dbar};
    const Barrier b = {bar, bar + 1};
    const Geo g = {R, n_steps, nb, da, db, pr, pc};
    cudaError_t e = launch_grid(K ? fused_bwd_ckpt_kernel<true> : fused_bwd_ckpt_kernel<false>,
                                blocks, sizeof(BlockSmem), (cudaStream_t)stream, in, out, scratch,
                                b, g, tab, plan);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
