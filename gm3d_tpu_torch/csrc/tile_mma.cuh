// The one matrix product of the kernels whose bodies are chains of small
// products (fused_attention.cu, patch_embed.cu): on the tensor cores, at fp32
// accuracy ("3xTF32"). A block of THREADS threads adds
//
//     acc(i, j) += sum_{k < K} A(i, k) * B(k, j),    i < M <= TILE, j < N <= TILE
//
// operands by element strides (a transposed operand is a swap of strides),
// ragged M, N, K zero-filled, the sum in fp32 registers, every thread of the
// block calls it (it holds barriers; the first also orders the caller's
// earlier shared-memory writes before any operand is read, so an epilogue may
// write a buffer that a LATER call reads, but not one that a later tile of
// the SAME product reads).
//
// The multiply-adds are mma.sync.aligned.m16n8k8 with TF32 operands and fp32
// accumulators. TF32 keeps 10 explicit mantissa bits; one pass would leave
// three digits, and the kernels' outputs feed a rank. So each
// operand element v is split into two TF32 numbers,
//
//     hi = v rounded to 11 significant bits        lo = v - hi   (exact)
//
// by Veltkamp's splitting, p = 8193 v, hi = p - (p - v): four fp32
// instructions an element and none on the integer or conversion pipes, which
// are slower (cvt.rna.tf32.f32 would do for hi). lo has up to 12 significant
// bits; the tensor core reads the top 10 of its mantissa and ignores the
// rest. Each k-step issues A_lo B_hi, A_hi B_lo, A_hi B_hi into the same
// accumulators, the small terms first. What is dropped, A_lo B_lo and the cut
// of lo, is of order 2^-21 |A| |B| at worst and without a preferred sign.
// ops/tile_mma.py is the plain version of this arithmetic.
//
// The tensor core adds into its C operand rounding toward zero, so a chain
// of mma through one accumulator drifts by up to an ulp a link, all one way
// (144 links at K = 384). Each k-tile (12 links) is therefore summed from
// zero and added to acc by an ordinary fp32 add, which rounds to nearest.
// CHAIN = true keeps the single chain; only the unit check uses it, to show
// the difference.
//
// The fragment map, stated once here and once in ops/tile_mma.py. The 8
// warps are 4 down x 2 across: warp w has rows 16 (w / 2) .. and columns
// 32 (w % 2) .., four m16n8 tiles side by side, 16 accumulators a thread.
// With g = lane / 4, t = lane % 4, acc[nt][r] is the output element
//
//     i = 16 (w / 2) + g + 8 (r / 2),    j = 32 (w % 2) + 8 nt + 2 t + r % 2
//
// (r is the register of the instruction's C fragment). The same thread owns
// the same element in every call, so a caller may sum into device memory
// across calls without atomics; a thread's outputs come in pairs (j, j + 1).
//
// Where the operands come from. A block of these kernels is one short chain
// of dependent products and has few warps to hide a wait behind, so what
// counts is how little stands between two mma, not how many there are:
//
//   - An operand that already lies in shared memory as fp32 (DIRECT: q, k, v,
//     the scores and their gradients, in the attention kernels' (64, 72)
//     buffers; the patch embed's activations, 64 rows of 136, 264 or 520
//     words) is read by the mma fragments where it is. Nothing is staged and
//     no barrier is held for it. Such a buffer must be whole, 64 rows (or
//     columns) by K rounded up to KTILE, with zeros outside its M x K (or
//     K x N) part: the attention kernels zero their buffers once and never
//     write outside the valid part, the patch embed writes zeros there.
//   - Any other operand (device memory, or bf16) is staged KTILE deep into an
//     fp32 panel with cp.async, 16 bytes a thread and zero-filled past the
//     ragged edges by the copy itself, into one of two panels in turn: the
//     copy of k-tile n + 1 is in flight while k-tile n is multiplied, no
//     register holds it, and one barrier a k-tile orders both. A bf16
//     operand, one that is not 16-byte aligned, or one whose declared unit
//     stride is not 1 (a weight that is not an nn.Linear view) is copied
//     element by element through registers into the same panel.
//
// The split is done on the fragments, in registers, not while staging: shared memory moves half the words
// it would for a hi and a lo panel, and it, not the arithmetic, is what these
// small products wait for.
//
// Layouts are compile-time. TK: the operand's depth k has unit stride (x, an
// nn.Linear weight, a row-major buffer); KT: its tile index has (a
// transposed view). Within a k-step the depth a lane multiplies is arbitrary
// as long as A and B agree, so one of two maps is used: PAIRS, lane
// t = lane % 4 takes depths 2 t and 2 t + 1 (one 8-byte read from a TK
// operand); or the instruction's own t and t + 4. A row stride of 8 mod 32
// words (the kernels' 72) is free of bank conflicts for TK under PAIRS and
// for KT under the other map, so a DIRECT operand picks the map (B first: it
// is two thirds of the reads), and a panel's row stride is chosen to suit
// the map: 40 or 36 words for TK, 68 or 72 for KT.
//
// mma is not touched by -fmad=false (the directory's flag), and the split's
// subtraction stands alone, so nothing here is contracted.

#pragma once

#include <cstdint>

#include "tile_gemm.cuh"  // THREADS, TILE, KTILE, to_float, store, zero

namespace gm3d {

enum Layout : int { TK = 0, KT = 1 };

constexpr int MMA_PANEL = TILE * (KTILE + 8);     // floats of the largest panel (TK, 40)
constexpr int MMA_STAGE_FLOATS = 4 * MMA_PANEL;   // A and B, two panels each: 40 KB

// the depth map of a product, from its DIRECT operands (see above)
__host__ __device__ constexpr bool pairs_map(Layout la, bool da, Layout lb, bool db) {
    return db ? lb == TK : da ? la == TK : true;
}
__host__ __device__ constexpr int panel_ld(Layout lay, bool pairs) {
    return lay == TK ? (pairs ? KTILE + 8 : KTILE + 4) : (pairs ? TILE + 4 : TILE + 8);
}
// floats of two panels of one operand at their own size (tile_mma's B_ONLY stage)
__host__ __device__ constexpr int mma_b_stage_floats(Layout lay, bool pairs) {
    return 2 * (lay == TK ? TILE : KTILE) * panel_ld(lay, pairs);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    // copies `bytes` (0..16) and fills the rest of the 16 with zeros
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// panel = P(t, k0 + kk) for t < TILE, kk < KTILE, zero outside T x K; rows of
// LD words, [t][kk] for TK and [kk][t] for KT
template <Layout LAY, int LD, typename TP>
__device__ __forceinline__ void stage_panel(float* panel, const TP* P, long s_t, long s_k, int T,
                                            int K, int k0) {
    const long s_unit = LAY == TK ? s_k : s_t, s_rows = LAY == TK ? s_t : s_k;
    if (sizeof(TP) == 4 && s_unit == 1 && s_rows % 4 == 0 &&
        reinterpret_cast<size_t>(P) % 16 == 0) {
#pragma unroll
        for (int r = 0; r < TILE * KTILE / 4 / THREADS; ++r) {
            const int v = threadIdx.x + THREADS * r;
            int t, kk, left;  // the vector's first element, and how much of it is inside
            if (LAY == TK) {
                t = v / (KTILE / 4), kk = 4 * (v % (KTILE / 4));
                left = t < T ? K - (k0 + kk) : 0;
            } else {
                kk = v / (TILE / 4), t = 4 * (v % (TILE / 4));
                left = k0 + kk < K ? T - t : 0;
            }
            left = max(0, min(4, left));
            const TP* src = left ? P + t * s_t + (k0 + kk) * s_k : P;
            cp_async16(panel + (LAY == TK ? t * LD + kk : kk * LD + t),
                       reinterpret_cast<const float*>(src), 4 * left);
        }
    } else {
        for (int e = threadIdx.x; e < TILE * KTILE; e += THREADS) {
            const int t = LAY == TK ? e / KTILE : e % TILE;
            const int kk = LAY == TK ? e % KTILE : e / TILE;
            const bool in = t < T && k0 + kk < K;
            panel[LAY == TK ? t * LD + kk : kk * LD + t] =
                in ? to_float(P[t * s_t + (k0 + kk) * s_k]) : 0.0f;
        }
    }
}

// Two depths of one tile index from an operand in shared memory. `p` is the
// element (tile index, first depth of the k-step).
template <Layout LAY, bool PAIRS>
__device__ __forceinline__ void frag_pair(const float* p, int ld, int t, float& x0, float& x1) {
    const int ka = PAIRS ? 2 * t : t, kb = PAIRS ? 2 * t + 1 : t + 4;
    if (LAY == TK && PAIRS) {
        const float2 v = *reinterpret_cast<const float2*>(p + ka);
        x0 = v.x, x1 = v.y;
    } else if (LAY == TK) {
        x0 = p[ka], x1 = p[kb];
    } else {
        x0 = p[ka * ld], x1 = p[kb * ld];
    }
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    // the intrinsics are never contracted into a multiply-add
    const float p = __fmul_rn(v, 8193.0f);  // 2^13 + 1
    const float h = __fsub_rn(p, __fsub_rn(p, v));
    hi = __float_as_uint(h);
    lo = __float_as_uint(__fsub_rn(v, h));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm(  // not volatile: a pure function of its operands, free to be scheduled
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// sum += one k-tile: `a` is the element (the lane's row g of the warp's 16,
// first depth of the tile), `b` the element (first depth, the lane's column g
// of the warp's 32). Straight-line code, all KTILE deep and all four n8 tiles
// wide whatever K and N are (what lies outside is zeros): a branch inside
// would fence the loads of one step from the mma of the step before.
template <Layout LA, Layout LB, bool PAIRS>
__device__ __forceinline__ void mma_tile(float (&sum)[4][4], const float* a, int a_ld,
                                         const float* b, int b_ld) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int k8 = 0; k8 < KTILE; k8 += 8) {
        const float* pa = a + (LA == TK ? k8 : k8 * a_ld);
        float av[4];  // rows g, g + 8 at the lane's first depth, then at its second
        frag_pair<LA, PAIRS>(pa, a_ld, t, av[0], av[2]);
        frag_pair<LA, PAIRS>(pa + 8 * (LA == TK ? a_ld : 1), a_ld, t, av[1], av[3]);
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(av[e], ah[e], al[e]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const float* pb = b + 8 * nt * (LB == TK ? b_ld : 1) + (LB == TK ? k8 : k8 * b_ld);
            float b0, b1;
            frag_pair<LB, PAIRS>(pb, b_ld, t, b0, b1);
            split(b0, bh[nt][0], bl[nt][0]);
            split(b1, bh[nt][1], bl[nt][1]);
        }
        // pass by pass over the four n8 tiles: two mma into the same
        // accumulator are three others apart, so none waits for the last
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(sum[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(sum[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(sum[nt], ah, bh[nt][0], bh[nt][1]);
    }
}

// forced inline: the accumulators must stay in the caller's registers.
// LA, LB: the operands' layouts. DA, DB: the operand is DIRECT (fp32 in
// shared memory in that layout, zero-padded); otherwise the layout is that
// of its panel, and the fast copy needs the matching stride to be 1.
// `stage` holds MMA_STAGE_FLOATS words: two panels of MMA_PANEL for A, then
// two for B. B_ONLY (A DIRECT, B staged) is for a kernel that has no room to
// spare: `stage` then holds B's two panels alone, back to back at their own
// size, mma_b_stage_floats() words.
template <Layout LA, bool DA, Layout LB, bool DB, bool CHAIN = false, bool B_ONLY = false,
          typename TA, typename TB>
__device__ __forceinline__ void tile_mma(float (&acc)[4][4],
                          const TA* A, long sa_i, long sa_k, int M,
                          const TB* B, long sb_k, long sb_j, int N,
                          int K, float* stage) {
    static_assert((!DA || sizeof(TA) == 4) && (!DB || sizeof(TB) == 4), "DIRECT means fp32");
    static_assert(!B_ONLY || (DA && !DB), "a stage of B's panels alone: A DIRECT, B staged");
    constexpr bool PAIRS = pairs_map(LA, DA, LB, DB);
    constexpr int PA_LD = panel_ld(LA, PAIRS), PB_LD = panel_ld(LB, PAIRS);
    constexpr int PB_SIZE = B_ONLY ? mma_b_stage_floats(LB, PAIRS) / 2 : MMA_PANEL;
    float* const stage_b = stage + (B_ONLY ? 0 : 2 * MMA_PANEL);
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
    const int row = 16 * (warp >> 1) + g, col = 32 * (warp & 1) + g;
    // a warp whose 16 x 32 lies past the ragged edge has only zeros to add (the
    // same for all its lanes, as mma.sync needs)
    const bool live = 16 * (warp >> 1) < M && 32 * (warp & 1) < N;
    const int a_ld = DA ? (int)(LA == TK ? sa_i : sa_k) : PA_LD;
    const int b_ld = DB ? (int)(LB == TK ? sb_j : sb_k) : PB_LD;
    __syncthreads();
    if (!DA) stage_panel<LA, PA_LD>(stage, A, sa_i, sa_k, M, K, 0);
    if (!DB) stage_panel<LB, PB_LD>(stage_b, B, sb_j, sb_k, N, K, 0);
    cp_async_commit();
    int buf = 0;
    for (int k0 = 0; k0 < K; k0 += KTILE, buf ^= 1) {
        if (!DA || !DB) {
            // k-tile k0 has landed for everyone, and everyone has left the
            // other panel: the next copy may start
            cp_async_wait();
            __syncthreads();
            if (k0 + KTILE < K) {
                if (!DA)
                    stage_panel<LA, PA_LD>(stage + (buf ^ 1) * MMA_PANEL, A, sa_i, sa_k, M, K,
                                           k0 + KTILE);
                if (!DB)
                    stage_panel<LB, PB_LD>(stage_b + (buf ^ 1) * PB_SIZE, B, sb_j, sb_k, N, K,
                                           k0 + KTILE);
                cp_async_commit();
            }
        }
        const float* a = DA ? reinterpret_cast<const float*>(A) +
                                  (LA == TK ? row * sa_i + k0 : k0 * sa_k + row)
                            : stage + buf * MMA_PANEL + (LA == TK ? row * PA_LD : row);
        const float* b = DB ? reinterpret_cast<const float*>(B) +
                                  (LB == TK ? col * sb_j + k0 : k0 * sb_k + col)
                            : stage_b + buf * PB_SIZE + (LB == TK ? col * PB_LD : col);
        if (!live) continue;
        if (CHAIN) {
            mma_tile<LA, LB, PAIRS>(acc, a, a_ld, b, b_ld);
        } else {
            float part[4][4];
            zero(part);
            mma_tile<LA, LB, PAIRS>(part, a, a_ld, b, b_ld);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[nt][r] += part[nt][r];
        }
    }
}

// f(i, j, value) for each of the thread's outputs that lies inside M x N,
// in the order of the fragment map above
template <typename F>
__device__ __forceinline__ void for_frag(const float (&acc)[4][4], int M, int N, F f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int i0 = 16 * (warp >> 1) + (lane >> 2), j0 = 32 * (warp & 1) + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = i0 + 8 * (r >> 1), j = j0 + 8 * nt + (r & 1);
            if (i < M && j < N) f(i, j, acc[nt][r]);
        }
}

// f(i, j, v0, v1) for each of the thread's output pairs (i, j), (i, j + 1) of
// the whole TILE x TILE (j is even), row by row: for epilogues that load and
// store eight bytes at a time
template <typename F>
__device__ __forceinline__ void for_frag_pairs(const float (&acc)[4][4], F f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int i0 = 16 * (warp >> 1) + (lane >> 2), j0 = 32 * (warp & 1) + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
            f(i0 + 8 * h, j0 + 8 * nt, acc[nt][2 * h], acc[nt][2 * h + 1]);
}

}  // namespace gm3d
