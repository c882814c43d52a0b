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
// kernel's operations saved).
//
// What bounds it: operations, 23.4 MFLOP a group of 32 points against 384 B
// in and 1.5 KB out. The three large products (conv2, conv3, conv4: all but
// 1% of the operations) run on the tensor cores through tile_mma.cuh at fp32
// accuracy (3xTF32: the tokens feed a rank, the geometric mask, where
// near-ties flip; one TF32 pass or bf16 would not do). Their A operands are
// the activations where they lie in shared memory (DIRECT: nothing is copied,
// no barrier is held for them), which is why the row strides are 8 mod 32
// words and why every activation buffer is written over all 64 rows, zeros
// past the block's last point. The weights (1.9 MB, every block streams all
// of them out of L2) are staged 32 deep by cp.async into two panels in turn.
// conv1 (K = 3), the maxima and the per-group term (1% of the operations, but
// a quarter of the weights' bytes) stay fp32 vector code.
//
// An epilogue may write a buffer that a LATER product reads, never one that a
// later tile of the SAME product reads: conv2 reads h1 and writes h2, conv3
// reads h2 and writes h3 over h1's room, conv4 reads h3 and writes its output
// tile into h2's room.

#include <initializer_list>

#include "tile_mma.cuh"

namespace {

using namespace gm3d;

constexpr int C1 = 128, C2 = 256, C3 = 512;
// row strides of the activations: 8 mod 32 words (see tile_mma.cuh: a DIRECT
// operand with k at unit stride, read in pairs)
constexpr int LD1 = C1 + 8, LD2 = C2 + 8, LD3 = C3 + 8, LDO = TILE + 8;
constexpr int MAX_GROUPS = 4;  // groups a block may own
// the weights' two (32, 68) panels: tile_mma's B_ONLY stage
constexpr int STAGE = mma_b_stage_floats(KT, pairs_map(TK, true, KT, false));
// Shared memory of a block, in floats: h2 64 x 264 = 16896, h3 64 x 520 =
// 33280, gmax and gterm 4 x (256 + 512) = 3072, the stage 2 x 32 x 68 = 4352;
// 57600 floats = 230,400 B of the 232,448 B a block may have.
constexpr int SMEM_FLOATS = TILE * LD2 + TILE * LD3 + MAX_GROUPS * (C2 + C3) + STAGE;
static_assert(SMEM_FLOATS * sizeof(float) <= 232448, "a block's shared memory");
static_assert(TILE * LDO <= TILE * LD2, "conv4's output tile lives in h2's room");

// acc += A W[:, c0 : c0 + n] for an activation buffer A (64, K) in shared
// memory, read in place, and an (in, out) weight matrix W of `ldw` columns
__device__ __forceinline__ void product(float (&acc)[4][4], const float* A, int lda, int rows,
                                        const float* W, int ldw, int n, int K, float* stage) {
    tile_mma<TK, true, KT, false, false, true>(acc, A, (long)lda, 1L, rows, W, (long)ldw, 1L, n,
                                               K, stage);
}

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
    float* tile = h2;
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
    {
        static_assert(THREADS % C1 == 0, "a thread keeps its column of h1 in every round");
        const int c = tid % C1;
        const float wx = p.w1[c], wy = p.w1[C1 + c], wz = p.w1[2 * C1 + c];
        const float b = p.b1[c], sc = p.s1[c], sh = p.t1[c];
        for (int r = tid / C1; r < TILE; r += THREADS / C1) {
            float v = 0.0f;
            if (r < rows) {
                float z = x[r * 3] * wx;
                z = fmaf(x[r * 3 + 1], wy, z);
                z = fmaf(x[r * 3 + 2], wz, z);
                v = fmaxf(fmaf(z + b, sc, sh), 0.0f);
            }
            h1[r * LD1 + c] = v;
        }
    }
    float acc[4][4];
    // conv2
    for (int c0 = 0; c0 < C2; c0 += TILE) {
        zero(acc);
        product(acc, h1, LD1, rows, p.w2 + c0, C2, TILE, C1, stage);
        for_frag_pairs(acc, [&](int i, int j, float v0, float v1) {
            const float2 b = __ldg(reinterpret_cast<const float2*>(p.b2 + c0 + j));
            *reinterpret_cast<float2*>(h2 + i * LD2 + c0 + j) =
                i < rows ? make_float2(v0 + b.x, v1 + b.y) : make_float2(0.0f, 0.0f);
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
    // the concat's first half, once per group: gterm = gmax W3[:C2] + b3. A
    // block reads 512 KB of W3 for it, and what it waits for is L2: 16-byte
    // loads, eight in flight a thread. A thread owns four columns and one half
    // of k; the halves meet in the stage, which no product is using
    {
        static_assert(THREADS == 2 * (C3 / 4) && MAX_GROUPS * C3 <= STAGE, "per-group term");
        const int c = 4 * (tid % (C3 / 4)), k0 = (tid / (C3 / 4)) * (C2 / 2);
        float t[MAX_GROUPS][4];
#pragma unroll
        for (int g = 0; g < MAX_GROUPS; ++g)
#pragma unroll
            for (int u = 0; u < 4; ++u) t[g][u] = 0.0f;
#pragma unroll 8
        for (int k = k0; k < k0 + C2 / 2; ++k) {
            const float4 w4 = *reinterpret_cast<const float4*>(p.w3 + k * C3 + c);
            const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int g = 0; g < MAX_GROUPS; ++g)
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (g < ng) t[g][u] = fmaf(gmax[g * C2 + k], w[u], t[g][u]);
        }
        if (k0 > 0)
#pragma unroll
            for (int g = 0; g < MAX_GROUPS; ++g)
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (g < ng) stage[g * C3 + c + u] = t[g][u];
        __syncthreads();
        if (k0 == 0)
#pragma unroll
            for (int g = 0; g < MAX_GROUPS; ++g)
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (g < ng)
                        gterm[g * C3 + c + u] = (t[g][u] + stage[g * C3 + c + u]) + p.b3[c + u];
    }
    __syncthreads();
    // conv3 (second half of W3) + BN2 + ReLU; h3 takes h1's room
    for (int c0 = 0; c0 < C3; c0 += TILE) {
        zero(acc);
        product(acc, h2, LD2, rows, p.w3 + (long)C2 * C3 + c0, C3, TILE, C2, stage);
        for_frag_pairs(acc, [&](int i, int j, float v0, float v1) {
            const int c = c0 + j;
            float2 v = make_float2(0.0f, 0.0f);
            if (i < rows) {
                const float2 sc = __ldg(reinterpret_cast<const float2*>(p.s2 + c));
                const float2 sh = __ldg(reinterpret_cast<const float2*>(p.t2 + c));
                const float2 gt = *reinterpret_cast<const float2*>(gterm + (i / S) * C3 + c);
                v.x = fmaxf(fmaf(v0 + gt.x, sc.x, sh.x), 0.0f);
                v.y = fmaxf(fmaf(v1 + gt.y, sc.y, sh.y), 0.0f);
            }
            *reinterpret_cast<float2*>(h3 + i * LD3 + c) = v;
        });
    }
    // conv4 + per-group max, one tile of columns at a time through h2's room
    for (int c0 = 0; c0 < C; c0 += TILE) {
        const int n = min(TILE, C - c0);
        zero(acc);
        product(acc, h3, LD3, rows, p.w4 + c0, C, n, C3, stage);
        for_frag(acc, rows, n, [&](int i, int j, float v) { tile[i * LDO + j] = v; });
        __syncthreads();
        for (int e = tid; e < ng * n; e += THREADS) {
            const int g = e / n, j = e % n;
            float m = tile[(g * S) * LDO + j];
            for (int s = 1; s < S; ++s) m = fmaxf(m, tile[(g * S + s) * LDO + j]);
            out[(long)(g0 + g) * C + c0 + j] = m + p.b4[c0 + j];
        }
        __syncthreads();
    }
}

}  // namespace

// pts (total_groups, S, 3) fp32 contiguous -> out (total_groups, C) fp32.
// Weights fp32 contiguous, (in, out); s1/t1, s2/t2 the folded BatchNorms. A
// block owns `gpb` groups: gpb <= 4 and gpb * S <= 64, or the call is refused
// (cudaErrorInvalidValue), as is a parameter that is not 16-byte aligned (w3
// and the epilogues' vectors are read 16 and 8 bytes at a time). w4's panels
// are copied 16 bytes at a time where C is a multiple of 4, else element by
// element. Returns the launch's cudaError_t (0 = success).
extern "C" int gm3d_patch_embed(const void* pts, const void* w1, const void* b1, const void* s1,
                                const void* t1, const void* w2, const void* b2, const void* w3,
                                const void* b3, const void* s2, const void* t2, const void* w4,
                                const void* b4, void* out, int total_groups, int S, int gpb,
                                int C, void* stream) {
    if (gpb < 1 || gpb > MAX_GROUPS || gpb * S > TILE) return (int)cudaErrorInvalidValue;
    if (total_groups < 1 || S < 1 || C < 1) return (int)cudaErrorInvalidValue;
    for (const void* param : {w1, b1, s1, t1, w2, b2, w3, b3, s2, t2, w4, b4})
        if (reinterpret_cast<size_t>(param) % 16 != 0) return (int)cudaErrorInvalidValue;
    const int smem = SMEM_FLOATS * (int)sizeof(float);  // 230,400 B, summed above
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
