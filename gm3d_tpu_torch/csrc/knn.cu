// Exact k-nearest-neighbour search for Hopper (sm_90a), one warp per query.
//
// Replaces the TPU kernel gm3d_tpu/ops/knn.py::_knn_kernel (a tile of
// queries against the whole cloud in on-chip memory, then k rounds of
// row-min / first-index / mask).
//
// Semantics: squared distance d = q2 - 2*cross + r2 to every reference
// point; the k smallest in ascending order, the FIRST index among equal
// distances. Points past N do not exist for the kernel. k <= N is the
// wrapper's duty.
//
// What bounds it: the bytes are small (B*N*12 + B*G*12 in, B*G*k*8 out; the
// (B, G, N) distance matrix never reaches device memory), and so are the
// operations (about 8*B*G*N flops for the distances plus the selection). The
// cost is the selection: k dependent rounds for each query. The design keeps
// a round short:
//   - a warp owns a query; lane l owns the reference points l, l+32, ... and
//     keeps their distances in a row of shared memory that only this lane
//     ever touches (bank = lane, so no conflicts and no barriers);
//   - each lane carries the minimum of its own points in registers. A round
//     is one warp-wide arg-min over these 32 candidates by shuffles; only the
//     lane that won masks its entry and rescans its N/32 points.
//
// Rounding: products and sums are written with __fmul_rn/__fadd_rn in the
// order of the plain PyTorch version (cross summed x, y, z) so that no FMA is
// formed and both choose the same neighbours.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

struct Cand {
    float v;
    int i;
};

// smaller value wins; on equal values the lower index wins
__device__ __forceinline__ Cand better(Cand a, Cand b) {
    return (b.v < a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Cand warp_argmin(Cand c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        Cand o;
        o.v = __shfl_xor_sync(0xffffffffu, c.v, off);
        o.i = __shfl_xor_sync(0xffffffffu, c.i, off);
        c = better(c, o);
    }
    return c;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                     __fmul_rn(az, bz));
}

__global__ void knn_kernel(const float* __restrict__ ref,
                           const float* __restrict__ query,
                           int* __restrict__ out_idx, float* __restrict__ out_dist,
                           int N, int G, int k) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int g = blockIdx.x * warps + warp;
    const int b = blockIdx.y;
    if (g >= G) return;  // whole warp leaves; the kernel has no block barrier

    float* row = smem + (size_t)warp * N;
    const float* r = ref + (size_t)b * N * 3;
    const float* q = query + ((size_t)b * G + g) * 3;
    const float qx = q[0], qy = q[1], qz = q[2];
    const float q2 = dot3(qx, qy, qz, qx, qy, qz);

    Cand mine;
    mine.v = CUDART_INF_F;
    mine.i = 0x7fffffff;
    for (int i = lane; i < N; i += 32) {
        const float rx = r[3 * i + 0], ry = r[3 * i + 1], rz = r[3 * i + 2];
        const float cross = dot3(qx, qy, qz, rx, ry, rz);
        const float r2 = dot3(rx, ry, rz, rx, ry, rz);
        const float d = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, cross)), r2);
        row[i] = d;
        // indices rise within a lane, so a strict test keeps the first
        if (d < mine.v) {
            mine.v = d;
            mine.i = i;
        }
    }

    int* oi = out_idx + ((size_t)b * G + g) * k;
    float* od = out_dist + ((size_t)b * G + g) * k;
    for (int j = 0; j < k; ++j) {
        const Cand w = warp_argmin(mine);
        if (lane == 0) {
            oi[j] = w.i;
            od[j] = w.v;
        }
        if ((w.i & 31) == lane) {  // the owner masks the winner and rescans
            row[w.i] = CUDART_INF_F;
            mine.v = CUDART_INF_F;
            mine.i = 0x7fffffff;
            for (int i = lane; i < N; i += 32) {
                const float d = row[i];
                if (d < mine.v) {
                    mine.v = d;
                    mine.i = i;
                }
            }
        }
    }
}

}  // namespace

// ref (B, N, 3), query (B, G, 3) fp32 contiguous -> idx (B, G, k) int32,
// dist (B, G, k) fp32. `warps` queries share a block and warps*N*4 bytes of
// shared memory. Returns the launch's cudaError_t (0 = success).
extern "C" int gm3d_knn(const void* ref, const void* query, void* idx, void* dist,
                        int B, int N, int G, int k, int warps, void* stream) {
    const size_t smem = (size_t)warps * N * sizeof(float);
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(knn_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid((G + warps - 1) / warps, B);
    knn_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
        (const float*)ref, (const float*)query, (int*)idx, (float*)dist, N, G, k);
    return (int)cudaGetLastError();
}
