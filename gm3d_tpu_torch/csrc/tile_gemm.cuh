// One register-tiled matrix product for the kernels of this directory whose
// bodies are chains of small products (patch_embed.cu, fused_attention.cu).
//
// A block of THREADS threads computes one output tile of at most TILE x TILE:
//
//     acc(i, j) += sum_{k < K} A(i, k) * B(k, j),    i < M <= TILE, j < N <= TILE
//
// A and B are addressed by element strides, so a transposed operand is a
// swap of strides and no copy. They may lie in device or in shared memory
// (generic pointers) and may be fp32 or bf16; the sum is fp32. Depth is
// walked KTILE at a time: both operands are staged into shared memory as
// (KTILE, TILE) panels, zero-filled past M, N and K (so ragged edges need no
// branch in the inner loop). Thread (ti, tj) = (tid / 16, tid % 16) owns rows
// 4 ti .. 4 ti + 3 and columns 4 tj .. 4 tj + 3: per k it reads one float4 of
// each panel (three shared-memory wavefronts a warp for 16 multiply-adds a
// thread) and does a 4 x 4 outer product. The next panels are fetched into
// registers before the current ones are multiplied, so the loads' latency
// hides behind the arithmetic.
//
// Staging has two orders. An operand whose tile index (i of A, j of B) has
// unit stride is copied row by row. Any other is transposed on the way: a
// warp fetches 4 tile indices x 8 consecutive k (whole 32-byte sectors when k
// has unit stride), which lands in 32 different banks of a panel. Reading a
// shared-memory operand in that order is free of bank conflicts when its row
// stride is 8 mod 32 words.
//
// Every thread of the block must call tile_gemm (it holds barriers). The
// first barrier also orders the caller's earlier shared-memory writes before
// the staging reads; an epilogue may therefore write a buffer that a LATER
// call reads, but not one that a later tile of the SAME product reads.
//
// The products are written with fmaf: the directory is compiled with
// -fmad=false (fps.cu and knn.cu compare floats), which would otherwise
// split every multiply-add.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gm3d {

constexpr int THREADS = 256;
constexpr int TILE = 64;
constexpr int KTILE = 32;
constexpr int S_LD = TILE + 4;  // a panel's row: float4-aligned, 4 mod 32 words
constexpr int STAGE_FLOATS = 2 * KTILE * S_LD;
constexpr int PER_THREAD = TILE * KTILE / THREADS;  // panel elements a thread stages

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
}

// The panel element (t = tile index, kk) that this thread stages in round r.
__device__ __forceinline__ void panel_slot(bool unit_t, int r, int& t, int& kk) {
    const int tid = threadIdx.x;
    if (unit_t) {
        t = tid % TILE;
        kk = r * (THREADS / TILE) + tid / TILE;
    } else {
        const int lane = tid & 31, w = r * (THREADS / 32) + (tid >> 5);
        t = 4 * (w >> 2) + (lane & 3);
        kk = 8 * (w & 3) + (lane >> 2);
    }
}

// reg[r] = P(t, k0 + kk) for the thread's slots, zero outside T x K.
template <typename TP>
__device__ __forceinline__ void fetch_panel(float (&reg)[PER_THREAD], const TP* P, long s_t,
                                            long s_k, int T, int K, int k0) {
    const bool unit_t = (s_t == 1);
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
        int t, kk;
        panel_slot(unit_t, r, t, kk);
        reg[r] = (t < T && k0 + kk < K) ? to_float(P[t * s_t + (k0 + kk) * s_k]) : 0.0f;
    }
}

__device__ __forceinline__ void put_panel(const float (&reg)[PER_THREAD], float* panel,
                                          bool unit_t) {
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
        int t, kk;
        panel_slot(unit_t, r, t, kk);
        panel[kk * S_LD + t] = reg[r];
    }
}

// forced inline: the accumulators must stay in the caller's registers
template <typename TA, typename TB>
__device__ __forceinline__ void tile_gemm(float (&acc)[4][4],
                          const TA* A, long sa_i, long sa_k, int M,
                          const TB* B, long sb_k, long sb_j, int N,
                          int K, float* stage) {
    float* sA = stage;
    float* sB = stage + KTILE * S_LD;
    const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
    float ra[PER_THREAD], rb[PER_THREAD];
    __syncthreads();
    fetch_panel(ra, A, sa_i, sa_k, M, K, 0);
    fetch_panel(rb, B, sb_j, sb_k, N, K, 0);
    for (int k0 = 0; k0 < K; k0 += KTILE) {
        put_panel(ra, sA, sa_i == 1);
        put_panel(rb, sB, sb_j == 1);
        __syncthreads();
        const bool more = k0 + KTILE < K;
        if (more) {
            fetch_panel(ra, A, sa_i, sa_k, M, K, k0 + KTILE);
            fetch_panel(rb, B, sb_j, sb_k, N, K, k0 + KTILE);
        }
#pragma unroll 8
        for (int kk = 0; kk < KTILE; ++kk) {
            const float4 a4 = *reinterpret_cast<const float4*>(sA + kk * S_LD + 4 * ti);
            const float4 b4 = *reinterpret_cast<const float4*>(sB + kk * S_LD + 4 * tj);
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
            const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(a[u], b[w], acc[u][w]);
        }
        if (more) __syncthreads();  // the panels are free to be overwritten
    }
}

// f(i, j, value) for each of the thread's outputs that lies inside M x N
template <typename F>
__device__ __forceinline__ void for_tile(const float (&acc)[4][4], int M, int N, F f) {
    const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int i = 4 * ti + a, j = 4 * tj + b;
            if (i < M && j < N) f(i, j, acc[a][b]);
        }
}

}  // namespace gm3d
