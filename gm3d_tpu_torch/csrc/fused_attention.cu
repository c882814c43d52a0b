// Fused multi-head self-attention sublayer for Hopper (sm_90a), forward and
// backward, one thread block per cloud.
//
// Replaces the TPU kernels gm3d_tpu/ops/fused_attention.py::_attn_kernel and
// ::_attn_bwd_kernel. What they compute, per cloud x (L, D) and per head h:
//
//   q, k, v = x Wq_h + bq_h, x Wk_h + bk_h, x Wv_h + bv_h        (L, hd)
//   a       = softmax(q k^T / sqrt(hd))          rows of length L exactly
//   y       = bproj + sum_h (a v) Wproj_h                          (L, D)
//
// and the backward of that, recomputed from x (nothing but x and the weights
// is kept from the forward): dx, dWqkv, dbqkv, dWproj, dbproj.
//
// The TPU kernel folds several clouds into one (bt*L, bt*L) score matrix
// under a block-diagonal mask to fill its matrix unit; here a block attends
// within its own cloud and no mask exists.
//
// Where things live. A cloud's x is 96 KB in fp32 and so is y; q, k, v and
// the scores of one head are 4 x 16 KB. Shared memory holds the head's
// buffers only, and the products read them where they lie (they are zeroed
// once and never written outside their valid L x hd or L x L part, so a
// ragged depth multiplies zeros). x (and dy) are re-read from device memory,
// in practice L2, through tile_mma's staging, once per head and product; y
// (and dx) are summed over the heads in an fp32 array in device memory that
// only the owning block touches (the same thread adds to the same element
// every time, so no atomics and no fences). Weights stream through the same
// staging, addressed by strides: the caller hands nn.Linear's (out, in)
// storage over as a transposed view and nothing is copied (any other layout
// is right too, and slower: it is staged element by element).
//
// Weight gradients are sums over clouds, and the blocks run at once: each
// block adds its share with atomicAdd into zeroed fp32 arrays. The order of
// that sum changes from run to run, and with it the last bits.
//
// Every product goes through tile_mma.cuh: the tensor cores (mma.sync, TF32
// operands) at fp32 accuracy, each operand split into two TF32 halves and
// three passes summed in fp32. One pass would keep three digits, and the
// EMA's predicted losses feed a rank. Softmax, biases and the sums over heads
// are fp32 vector code. Sizes are L <= 64, hd <= 64.
//
// What bounds it. By the count, operations: 2 L D (4 D + 2 L) flops a cloud
// forward (82 MFLOP at L 64, D 384), about 2.6 times that backward, against
// 2 x 96 KB of traffic a cloud. On the card, the length of a block's chain: a
// cloud is 66 small products forward and 312 backward, one after the other
// behind barriers, with eight warps to hide a wait behind. A block takes as
// long with its SM to itself as with every SM busy; the forward fits two
// blocks an SM, the backward one (166 KB of shared memory), so 256 clouds
// take it two rounds.

#include "tile_mma.cuh"

namespace {

using namespace gm3d;

constexpr int LD = TILE + 8;        // row stride of the per-head buffers: 8 mod 32 words
constexpr int BUF = TILE * LD;      // one (64, 64) buffer
constexpr int FWD_BUFS = 4, BWD_BUFS = 7;

template <typename T>
struct Weights {
    const T* wqkv; long q_k, q_j;   // Wqkv(k, j) = wqkv[k*q_k + j*q_j], (D, 3D)
    const T* bqkv;                  // (3D) or null
    const T* wproj; long p_k, p_j;  // Wproj(k, j), (D, D)
    const T* bproj;                 // (D)
};

// dst(L, hd) = x Wqkv[:, part*D + h*hd ...] + bias
template <typename T>
__device__ void project(float* dst, const T* x, const Weights<T>& w, int part, int h,
                        int L, int D, int hd, float* stage) {
    const long col0 = (long)part * D + (long)h * hd;
    float acc[4][4];
    zero(acc);
    tile_mma<TK, false, TK, false>(acc, x, (long)D, 1L, L, w.wqkv + col0 * w.q_j, w.q_k, w.q_j,
                                   hd, D, stage);
    for_frag(acc, L, hd, [&](int i, int j, float v) {
        if (w.bqkv) v += to_float(w.bqkv[col0 + j]);
        dst[i * LD + j] = v;
    });
}

// s(L, L) = softmax(q k^T * scale) over each row
__device__ void scores_softmax(float* s, const float* q, const float* k, int L, int hd,
                               float scale, float* stage) {
    float acc[4][4];
    zero(acc);
    tile_mma<TK, true, TK, true>(acc, q, (long)LD, 1L, L, k, 1L, (long)LD, L, hd, stage);
    for_frag(acc, L, L, [&](int i, int j, float v) { s[i * LD + j] = v * scale; });
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < L; i += THREADS / 32) {
        float m = -3.0e38f;
        for (int j = lane; j < L; j += 32) m = fmaxf(m, s[i * LD + j]);
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float sum = 0.0f;
        for (int j = lane; j < L; j += 32) {
            const float e = expf(s[i * LD + j] - m);
            s[i * LD + j] = e;
            sum += e;
        }
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        for (int j = lane; j < L; j += 32) s[i * LD + j] = s[i * LD + j] / sum;
    }
    __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks an SM: at most 128 registers
attn_fwd_kernel(const T* __restrict__ x, Weights<T> w, float* yacc, T* y,
                int L, int D, int H) {
    extern __shared__ __align__(16) float smem[];
    float* q = smem;
    float* k = smem + BUF;
    float* v = smem + 2 * BUF;
    float* s = smem + 3 * BUF;
    float* stage = smem + FWD_BUFS * BUF;
    for (int e = threadIdx.x; e < FWD_BUFS * BUF; e += THREADS) smem[e] = 0.0f;
    const int hd = D / H;
    const float scale = 1.0f / sqrtf((float)hd);
    const long base = (long)blockIdx.x * L * D;
    const T* xb = x + base;

    for (int h = 0; h < H; ++h) {
        project(q, xb, w, 0, h, L, D, hd, stage);
        project(k, xb, w, 1, h, L, D, hd, stage);
        project(v, xb, w, 2, h, L, D, hd, stage);
        scores_softmax(s, q, k, L, hd, scale, stage);
        // o = a v, into q's buffer (q is spent)
        float acc[4][4];
        zero(acc);
        tile_mma<TK, true, KT, true>(acc, s, (long)LD, 1L, L, v, (long)LD, 1L, hd, L, stage);
        for_frag(acc, L, hd, [&](int i, int j, float val) { q[i * LD + j] = val; });
        // y += o Wproj[h*hd : (h+1)*hd, :]
        for (int c0 = 0; c0 < D; c0 += TILE) {
            const int n = min(TILE, D - c0);
            zero(acc);
            tile_mma<TK, true, TK, false>(
                acc, q, (long)LD, 1L, L, w.wproj + (long)h * hd * w.p_k + (long)c0 * w.p_j,
                w.p_k, w.p_j, n, hd, stage);
            for_frag(acc, L, n, [&](int i, int j, float val) {
                const long at = base + (long)i * D + c0 + j;
                val += (h == 0) ? to_float(w.bproj[c0 + j]) : yacc[at];
                if (h == H - 1) store(y + at, val);
                else yacc[at] = val;
            });
        }
    }
}

// dst(i, j) += acc(i, j) over the clouds, for the thread's outputs inside
// M x N. A thread owns pairs of neighbouring columns (j even, j + 1), so
// where j has unit stride a pair goes out as one 8-byte atomic (sm_90 adds a
// float2 at once): the eight lanes of a row fill two whole 32-byte sectors.
// The callers orient their products so that j is the unit stride of the
// gradient of an nn.Linear weight; any other layout takes scalar atomics.
__device__ __forceinline__ void add_tile(const float (&acc)[4][4], int M, int N, float* dst,
                                         long s_i, long s_j) {
    if (s_j == 1 && s_i % 2 == 0 && (((size_t)dst) & 7) == 0) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        const int i0 = 16 * (warp >> 1) + (lane >> 2), j0 = 32 * (warp & 1) + 2 * (lane & 3);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; r += 2) {
                const int i = i0 + 4 * r, j = j0 + 8 * nt;
                if (i >= M || j >= N) continue;
                float* at = dst + i * s_i + j;
                if (j + 1 < N)
                    atomicAdd(reinterpret_cast<float2*>(at),
                              make_float2(acc[nt][r], acc[nt][r + 1]));
                else
                    atomicAdd(at, acc[nt][r]);
            }
    } else {
        for_frag(acc, M, N, [&](int i, int j, float val) {
            atomicAdd(dst + i * s_i + j * s_j, val);
        });
    }
}

template <typename T>
struct Grads {
    float* dxacc; T* dx;            // (B, L, D)
    float* dwqkv; long q_k, q_j;    // (D, 3D), zeroed by the caller
    float* dbqkv;                   // (3D) zeroed, or null
    float* dwproj; long p_k, p_j;   // (D, D) zeroed
    float* dbproj;                  // (D) zeroed
};

// g (L, hd) is the gradient of q, k or v (part 0, 1, 2) of head h: send it on
// to the bias, the weight and x.
template <typename T>
__device__ void spend(const float* g, const T* xb, const Weights<T>& w, const Grads<T>& gr,
                      int part, int h, bool first, bool last, long base,
                      int L, int D, int hd, float* stage) {
    const long col0 = (long)part * D + (long)h * hd;
    __syncthreads();
    if (gr.dbqkv) {
        for (int j = threadIdx.x; j < hd; j += THREADS) {
            float sum = 0.0f;
            for (int l = 0; l < L; ++l) sum += g[l * LD + j];
            atomicAdd(gr.dbqkv + col0 + j, sum);
        }
    }
    float acc[4][4];
    for (int r0 = 0; r0 < D; r0 += TILE) {
        const int n = min(TILE, D - r0);
        // dW[r0.., col0..]^T += g^T x[:, r0..]: transposed, so that a thread's
        // pairs run along dW's rows, the unit stride of an nn.Linear gradient
        zero(acc);
        tile_mma<KT, true, KT, false>(acc, g, 1L, (long)LD, hd, xb + r0, (long)D, 1L, n, L, stage);
        add_tile(acc, hd, n, gr.dwqkv + (long)r0 * gr.q_k + col0 * gr.q_j, gr.q_j, gr.q_k);
        // dx[:, r0..] += g W[r0.., col0..]^T
        zero(acc);
        tile_mma<TK, true, KT, false>(acc, g, (long)LD, 1L, L,
                                      w.wqkv + (long)r0 * w.q_k + col0 * w.q_j, w.q_j, w.q_k, n,
                                      hd, stage);
        for_frag(acc, L, n, [&](int i, int j, float val) {
            const long at = base + (long)i * D + r0 + j;
            if (!first) val += gr.dxacc[at];
            if (last) store(gr.dx + at, val);
            else gr.dxacc[at] = val;
        });
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, Weights<T> w, Grads<T> gr,
                int L, int D, int H) {
    extern __shared__ __align__(16) float smem[];
    float* q = smem;
    float* k = smem + BUF;
    float* v = smem + 2 * BUF;
    float* a = smem + 3 * BUF;
    float* dO = smem + 4 * BUF;
    float* ds = smem + 5 * BUF;
    float* tmp = smem + 6 * BUF;
    float* stage = smem + BWD_BUFS * BUF;
    for (int e = threadIdx.x; e < BWD_BUFS * BUF; e += THREADS) smem[e] = 0.0f;
    const int hd = D / H;
    const float scale = 1.0f / sqrtf((float)hd);
    const long base = (long)blockIdx.x * L * D;
    const T* xb = x + base;
    const T* dyb = dy + base;

    for (int c = threadIdx.x; c < D; c += THREADS) {
        float sum = 0.0f;
        for (int l = 0; l < L; ++l) sum += to_float(dyb[(long)l * D + c]);
        atomicAdd(gr.dbproj + c, sum);
    }

    float acc[4][4];
    for (int h = 0; h < H; ++h) {
        project(q, xb, w, 0, h, L, D, hd, stage);
        project(k, xb, w, 1, h, L, D, hd, stage);
        project(v, xb, w, 2, h, L, D, hd, stage);
        scores_softmax(a, q, k, L, hd, scale, stage);
        // o = a v
        zero(acc);
        tile_mma<TK, true, KT, true>(acc, a, (long)LD, 1L, L, v, (long)LD, 1L, hd, L, stage);
        for_frag(acc, L, hd, [&](int i, int j, float val) { tmp[i * LD + j] = val; });
        // dWproj[h*hd.., :]^T += dy^T o (transposed for the same reason as in spend)
        for (int c0 = 0; c0 < D; c0 += TILE) {
            const int n = min(TILE, D - c0);
            zero(acc);
            tile_mma<KT, false, KT, true>(acc, dyb + c0, 1L, (long)D, n, tmp, (long)LD, 1L, hd, L,
                                          stage);
            add_tile(acc, n, hd, gr.dwproj + (long)h * hd * gr.p_k + (long)c0 * gr.p_j,
                     gr.p_j, gr.p_k);
        }
        // do = dy Wproj[h*hd.., :]^T
        zero(acc);
        tile_mma<TK, false, KT, false>(acc, dyb, (long)D, 1L, L,
                                       w.wproj + (long)h * hd * w.p_k, w.p_j, w.p_k, hd, D, stage);
        for_frag(acc, L, hd, [&](int i, int j, float val) { dO[i * LD + j] = val; });
        // da = do v^T
        zero(acc);
        tile_mma<TK, true, TK, true>(acc, dO, (long)LD, 1L, L, v, 1L, (long)LD, L, hd, stage);
        for_frag(acc, L, L, [&](int i, int j, float val) { ds[i * LD + j] = val; });
        __syncthreads();
        // ds = a (da - sum_j da a) scale, row by row
        {
            const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
            for (int i = warp; i < L; i += THREADS / 32) {
                float dot = 0.0f;
                for (int j = lane; j < L; j += 32) dot += ds[i * LD + j] * a[i * LD + j];
                for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
                for (int j = lane; j < L; j += 32)
                    ds[i * LD + j] = a[i * LD + j] * (ds[i * LD + j] - dot) * scale;
            }
        }
        // dq = ds k
        zero(acc);
        tile_mma<TK, true, KT, true>(acc, ds, (long)LD, 1L, L, k, (long)LD, 1L, hd, L, stage);
        for_frag(acc, L, hd, [&](int i, int j, float val) { tmp[i * LD + j] = val; });
        spend(tmp, xb, w, gr, 0, h, h == 0, false, base, L, D, hd, stage);
        // dk = ds^T q
        zero(acc);
        tile_mma<KT, true, KT, true>(acc, ds, 1L, (long)LD, L, q, (long)LD, 1L, hd, L, stage);
        for_frag(acc, L, hd, [&](int i, int j, float val) { tmp[i * LD + j] = val; });
        spend(tmp, xb, w, gr, 1, h, false, false, base, L, D, hd, stage);
        // dv = a^T do
        zero(acc);
        tile_mma<KT, true, KT, true>(acc, a, 1L, (long)LD, L, dO, (long)LD, 1L, hd, L, stage);
        for_frag(acc, L, hd, [&](int i, int j, float val) { tmp[i * LD + j] = val; });
        spend(tmp, xb, w, gr, 2, h, false, h == H - 1, base, L, D, hd, stage);
        __syncthreads();
    }
}

template <typename T>
int launch_fwd(const void* x, const void* wqkv, long q_k, long q_j, const void* bqkv,
               const void* wproj, long p_k, long p_j, const void* bproj,
               void* yacc, void* y, int B, int L, int D, int H, cudaStream_t stream) {
    const int smem = (FWD_BUFS * BUF + MMA_STAGE_FLOATS) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    Weights<T> w{(const T*)wqkv, q_k, q_j, (const T*)bqkv, (const T*)wproj, p_k, p_j,
                 (const T*)bproj};
    attn_fwd_kernel<T><<<B, THREADS, smem, stream>>>((const T*)x, w, (float*)yacc, (T*)y,
                                                     L, D, H);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* wqkv, long q_k, long q_j,
               const void* bqkv, const void* wproj, long p_k, long p_j,
               void* dxacc, void* dx, void* dwqkv, long gq_k, long gq_j, void* dbqkv,
               void* dwproj, long gp_k, long gp_j, void* dbproj,
               int B, int L, int D, int H, cudaStream_t stream) {
    const int smem = (BWD_BUFS * BUF + MMA_STAGE_FLOATS) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    Weights<T> w{(const T*)wqkv, q_k, q_j, (const T*)bqkv, (const T*)wproj, p_k, p_j, nullptr};
    Grads<T> g{(float*)dxacc, (T*)dx, (float*)dwqkv, gq_k, gq_j, (float*)dbqkv,
               (float*)dwproj, gp_k, gp_j, (float*)dbproj};
    attn_bwd_kernel<T><<<B, THREADS, smem, stream>>>((const T*)x, (const T*)dy, w, g, L, D, H);
    return (int)cudaGetLastError();
}

}  // namespace

// x (B, L, D) contiguous, fp32 or bf16 (`bf16` != 0), weights of the same type.
// Wqkv(k, j) = wqkv[k*q_k + j*q_j] is (D, 3D) with columns laid out (3, H, hd),
// Wproj(k, j) = wproj[k*p_k + j*p_j] is (D, D); bqkv may be null. y has x's
// type; yacc is fp32 scratch of y's shape (for fp32 it may be y itself).
// Returns the launch's cudaError_t (0 = success).
extern "C" int gm3d_attn_fwd(const void* x, const void* wqkv, long q_k, long q_j,
                             const void* bqkv, const void* wproj, long p_k, long p_j,
                             const void* bproj, void* yacc, void* y,
                             int B, int L, int D, int H, int bf16, void* stream) {
    if (bf16)
        return launch_fwd<__nv_bfloat16>(x, wqkv, q_k, q_j, bqkv, wproj, p_k, p_j, bproj,
                                         yacc, y, B, L, D, H, (cudaStream_t)stream);
    return launch_fwd<float>(x, wqkv, q_k, q_j, bqkv, wproj, p_k, p_j, bproj,
                             yacc, y, B, L, D, H, (cudaStream_t)stream);
}

// Backward of gm3d_attn_fwd from x, dy and the weights. dx has x's type, dxacc
// is fp32 scratch (for fp32 it may be dx itself). dwqkv, dbqkv (or null),
// dwproj, dbproj are fp32 and ZEROED by the caller; the weight gradients are
// addressed by their own strides like the weights.
extern "C" int gm3d_attn_bwd(const void* x, const void* dy, const void* wqkv, long q_k,
                             long q_j, const void* bqkv, const void* wproj, long p_k,
                             long p_j, void* dxacc, void* dx, void* dwqkv, long gq_k,
                             long gq_j, void* dbqkv, void* dwproj, long gp_k, long gp_j,
                             void* dbproj, int B, int L, int D, int H, int bf16,
                             void* stream) {
    if (bf16)
        return launch_bwd<__nv_bfloat16>(x, dy, wqkv, q_k, q_j, bqkv, wproj, p_k, p_j, dxacc,
                                         dx, dwqkv, gq_k, gq_j, dbqkv, dwproj, gp_k, gp_j,
                                         dbproj, B, L, D, H, (cudaStream_t)stream);
    return launch_bwd<float>(x, dy, wqkv, q_k, q_j, bqkv, wproj, p_k, p_j, dxacc, dx, dwqkv,
                             gq_k, gq_j, dbqkv, dwproj, gp_k, gp_j, dbproj, B, L, D, H,
                             (cudaStream_t)stream);
}
