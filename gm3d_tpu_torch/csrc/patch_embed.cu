// Fused eval-mode mini-PointNet patch embed for Hopper (sm_90a).
//
// Replaces the TPU kernel gm3d_tpu/ops/patch_embed.py::_kernel. Per group of
// S points (BatchNorm already folded to scale/shift by the wrapper):
//
//   h1 = relu((p W1 + b1) s1 + t1)                       (S, 128)
//   h2 = h1 W2 + b2                                      (S, 256)
//   g  = max over the group's points of h2               (256)
//   h3 = relu(([g, h2] W3 + b3) s2 + t2)                 (S, 512)
//   out = max over the group's points of (h3 W4 + b4)    (C)
//
// The TPU kernel takes a whole cloud (G*S rows) a grid step, pads the three
// coordinates to 128 lanes and materialises the concat. None of that is
// carried over. A group's maxima need only its own points, so a block owns
// as many whole groups as fit in 64 rows (two at S = 32) and keeps every
// activation of those rows in shared memory: h2 (66 KB) and h3 (130 KB; h1
// lives in h3's room before h3 exists). The concat is never built: the
// half of W3 that meets g is applied once per group, not once per point,
// and enters conv3 as a per-group bias (that is a quarter of the TPU
// kernel's operations saved). The weights (1.9 MB) stream out of L2 through
// tile_gemm's staging.
//
// What bounds it: operations, 23.4 MFLOP a group of 32 points in fp32 FFMA
// against 384 B in and 1.5 KB out. Everything stays fp32: the tokens feed a
// rank (the geometric mask), where near-ties flip.

#include "tile_gemm.cuh"

namespace {

using namespace gm3d;

constexpr int C1 = 128, C2 = 256, C3 = 512;
// row strides of the activations: 8 mod 32 words (see tile_gemm.cuh)
constexpr int LD1 = C1 + 8, LD2 = C2 + 8, LD3 = C3 + 8;
constexpr int MAX_GROUPS = 4;  // groups a block may own

struct Params {
    const float *w1, *b1, *s1, *t1;  // (3, C1), (C1) x3
    const float *w2, *b2;            // (C1, C2), (C2)
    const float *w3, *b3, *s2, *t2;  // (2*C2, C3), (C3) x3
    const float *w4, *b4;            // (C3, C), (C)
};

__global__ void __launch_bounds__(THREADS)
patch_embed_kernel(const float* __restrict__ pts, Params p, float* __restrict__ out,
                   int total_groups, int S, int gpb, int C) {
    extern __shared__ __align__(16) float smem[];
    float* h2 = smem;                        // TILE x C2, later a TILE x TILE output tile
    float* h3 = h2 + TILE * LD2;             // TILE x C3
    float* h1 = h3;                          // TILE x C1, dead before h3 is written
    float* gmax = h3 + TILE * LD3;           // MAX_GROUPS x C2
    float* gterm = gmax + MAX_GROUPS * C2;   // MAX_GROUPS x C3
    float* stage = gterm + MAX_GROUPS * C3;
    const int tid = threadIdx.x;
    const int g0 = blockIdx.x * gpb;
    const int ng = min(gpb, total_groups - g0);
    const int rows = ng * S;
    const float* x = pts + (long)g0 * S * 3;

    // conv1 + BN1 + ReLU
    for (int e = tid; e < TILE * C1; e += THREADS) {
        const int r = e / C1, c = e % C1;
        float v = 0.0f;
        if (r < rows) {
            float z = x[r * 3] * p.w1[c];
            z = fmaf(x[r * 3 + 1], p.w1[C1 + c], z);
            z = fmaf(x[r * 3 + 2], p.w1[2 * C1 + c], z);
            v = fmaxf(fmaf(z + p.b1[c], p.s1[c], p.t1[c]), 0.0f);
        }
        h1[r * LD1 + c] = v;
    }
    float acc[4][4];
    // conv2
    for (int c0 = 0; c0 < C2; c0 += TILE) {
        zero(acc);
        tile_gemm(acc, h1, (long)LD1, 1L, rows, p.w2 + c0, (long)C2, 1L, TILE, C1, stage);
        for_tile(acc, rows, TILE, [&](int i, int j, float v) {
            h2[i * LD2 + c0 + j] = v + p.b2[c0 + j];
        });
    }
    __syncthreads();
    // per-group max of h2
    for (int e = tid; e < ng * C2; e += THREADS) {
        const int g = e / C2, c = e % C2;
        float m = h2[(g * S) * LD2 + c];
        for (int s = 1; s < S; ++s) m = fmaxf(m, h2[(g * S + s) * LD2 + c]);
        gmax[e] = m;
    }
    __syncthreads();
    // the concat's first half, once per group: gterm = gmax W3[:C2] + b3
    for (int c = tid; c < C3; c += THREADS) {
        float t[MAX_GROUPS];
#pragma unroll
        for (int g = 0; g < MAX_GROUPS; ++g) t[g] = 0.0f;
        for (int k = 0; k < C2; ++k) {
            const float wv = p.w3[k * C3 + c];
#pragma unroll
            for (int g = 0; g < MAX_GROUPS; ++g)
                if (g < ng) t[g] = fmaf(gmax[g * C2 + k], wv, t[g]);
        }
#pragma unroll
        for (int g = 0; g < MAX_GROUPS; ++g)
            if (g < ng) gterm[g * C3 + c] = t[g] + p.b3[c];
    }
    __syncthreads();
    // conv3 (second half of W3) + BN2 + ReLU; h3 takes h1's room
    for (int c0 = 0; c0 < C3; c0 += TILE) {
        zero(acc);
        tile_gemm(acc, h2, (long)LD2, 1L, rows, p.w3 + (long)C2 * C3 + c0, (long)C3, 1L, TILE,
                  C2, stage);
        for_tile(acc, rows, TILE, [&](int i, int j, float v) {
            const int c = c0 + j;
            v += gterm[(i / S) * C3 + c];
            h3[i * LD3 + c] = fmaxf(fmaf(v, p.s2[c], p.t2[c]), 0.0f);
        });
    }
    // conv4 + per-group max, one tile of columns at a time through h2's room
    for (int c0 = 0; c0 < C; c0 += TILE) {
        const int n = min(TILE, C - c0);
        zero(acc);
        tile_gemm(acc, h3, (long)LD3, 1L, rows, p.w4 + c0, (long)C, 1L, n, C3, stage);
        for_tile(acc, rows, n, [&](int i, int j, float v) { h2[i * TILE + j] = v; });
        __syncthreads();
        for (int e = tid; e < ng * n; e += THREADS) {
            const int g = e / n, j = e % n;
            float m = h2[(g * S) * TILE + j];
            for (int s = 1; s < S; ++s) m = fmaxf(m, h2[(g * S + s) * TILE + j]);
            out[(long)(g0 + g) * C + c0 + j] = m + p.b4[c0 + j];
        }
        __syncthreads();
    }
}

}  // namespace

// pts (total_groups, S, 3) fp32 contiguous -> out (total_groups, C) fp32.
// Weights fp32 contiguous, (in, out); s1/t1, s2/t2 the folded BatchNorms. A
// block owns `gpb` groups: gpb <= 4 and gpb * S <= 64. Returns the launch's
// cudaError_t (0 = success).
extern "C" int gm3d_patch_embed(const void* pts, const void* w1, const void* b1, const void* s1,
                                const void* t1, const void* w2, const void* b2, const void* w3,
                                const void* b3, const void* s2, const void* t2, const void* w4,
                                const void* b4, void* out, int total_groups, int S, int gpb,
                                int C, void* stream) {
    if (gpb < 1 || gpb > MAX_GROUPS || gpb * S > TILE) return (int)cudaErrorInvalidValue;
    const int smem = (TILE * LD2 + TILE * LD3 + MAX_GROUPS * (C2 + C3) + STAGE_FLOATS)
                     * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(patch_embed_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    Params p{(const float*)w1, (const float*)b1, (const float*)s1, (const float*)t1,
             (const float*)w2, (const float*)b2, (const float*)w3, (const float*)b3,
             (const float*)s2, (const float*)t2, (const float*)w4, (const float*)b4};
    const int blocks = (total_groups + gpb - 1) / gpb;
    patch_embed_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)pts, p, (float*)out, total_groups, S, gpb, C);
    return (int)cudaGetLastError();
}
