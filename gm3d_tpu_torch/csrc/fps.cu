// Furthest-point sampling for Hopper (sm_90a), one thread block per cloud.
//
// Replaces the TPU kernels gm3d_tpu/ops/fps.py::_fps_batched_kernel (a tile
// of clouds on sublanes, points on lanes) and ::_fps_kernel (one cloud per
// grid step). On a GPU the blocks run side by side, so one block per cloud
// covers both.
//
// Semantics: pick 0 is index 0; every later pick is the point with the
// largest running minimum squared distance to the picked set, the LOWEST
// index among equal values. Lanes past N are never read or picked.
//
// What bounds it: not bytes (B*N*12 in, B*n*4 out) and not operations
// (about 8*B*n*N flops), but the chain of n-1 DEPENDENT rounds. Round r
// cannot start before round r-1 has named its winner, and naming it takes a
// block-wide arg-max. The design therefore spends its care on the length of
// one round:
//   - coordinates and the running minimum stay in shared memory for the
//     whole loop (16 bytes a point), laid out so that neighbouring threads
//     touch neighbouring words;
//   - a thread owns the same points in every round, so the running minimum
//     needs no barrier of its own;
//   - the arg-max is two levels of warp shuffles with ONE __syncthreads a
//     round: every warp writes its candidate to a slot, and after the barrier
//     every warp reduces all slots redundantly, so no second barrier is
//     needed to broadcast the winner. The slots are double-buffered by the
//     round's parity so that a fast warp cannot overwrite what a slow one
//     still reads.
//
// Rounding: the distance is written with __fmul_rn/__fadd_rn in the order
// (dx*dx + dy*dy) + dz*dz so that the compiler cannot contract it into FMAs;
// it is then bit-identical to the plain PyTorch version and the greedy
// selection picks the same indices.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

struct Cand {
    float v;
    int i;
};

// larger value wins; on equal values the lower index wins
__device__ __forceinline__ Cand better(Cand a, Cand b) {
    return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Cand warp_argmax(Cand c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        Cand o;
        o.v = __shfl_xor_sync(0xffffffffu, c.v, off);
        o.i = __shfl_xor_sync(0xffffffffu, c.i, off);
        c = better(c, o);
    }
    return c;
}

__global__ void fps_kernel(const float* __restrict__ xyz, int* __restrict__ out,
                           int N, int n) {
    extern __shared__ float smem[];
    float* sx = smem;
    float* sy = sx + N;
    float* sz = sy + N;
    float* sd = sz + N;
    __shared__ float slot_v[2][32];
    __shared__ int slot_i[2][32];

    const int tid = threadIdx.x;
    const int T = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = T >> 5;
    const float* cloud = xyz + (size_t)blockIdx.x * N * 3;
    int* o = out + (size_t)blockIdx.x * n;

    for (int i = tid; i < N; i += T) {
        sx[i] = cloud[3 * i + 0];
        sy[i] = cloud[3 * i + 1];
        sz[i] = cloud[3 * i + 2];
        sd[i] = CUDART_INF_F;
    }
    if (tid == 0) o[0] = 0;
    __syncthreads();

    int last = 0;
    for (int r = 1; r < n; ++r) {
        const float cx = sx[last], cy = sy[last], cz = sz[last];
        Cand c;
        c.v = -CUDART_INF_F;
        c.i = 0x7fffffff;
        for (int i = tid; i < N; i += T) {
            const float dx = __fsub_rn(sx[i], cx);
            const float dy = __fsub_rn(sy[i], cy);
            const float dz = __fsub_rn(sz[i], cz);
            const float d = __fadd_rn(
                __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
            const float m = fminf(sd[i], d);
            sd[i] = m;
            // indices rise within a thread, so a strict test keeps the lowest
            if (m > c.v) {
                c.v = m;
                c.i = i;
            }
        }
        c = warp_argmax(c);
        const int buf = r & 1;
        if (lane == 0) {
            slot_v[buf][warp] = c.v;
            slot_i[buf][warp] = c.i;
        }
        __syncthreads();
        Cand w;
        w.v = lane < nwarps ? slot_v[buf][lane] : -CUDART_INF_F;
        w.i = lane < nwarps ? slot_i[buf][lane] : 0x7fffffff;
        w = warp_argmax(w);
        last = w.i;
        if (tid == 0) o[r] = last;
    }
}

}  // namespace

// xyz (B, N, 3) fp32 contiguous -> out (B, n) int32. `threads` is a multiple
// of 32 in [32, 1024]. Returns the launch's cudaError_t (0 = success).
extern "C" int gm3d_fps(const void* xyz, void* out, int B, int N, int n,
                        int threads, void* stream) {
    const size_t smem = (size_t)N * 4 * sizeof(float);
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(fps_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    fps_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float*)xyz, (int*)out, N, n);
    return (int)cudaGetLastError();
}
