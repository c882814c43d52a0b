// Furthest-point sampling for Hopper (sm_90a): a cloud's points and running
// minima live in its threads' registers, and every round's arg-max is two
// redux.sync a level.
//
// Replaces the TPU kernels gm3d_tpu/ops/fps.py::_fps_batched_kernel (:170, a
// tile of clouds on sublanes, points on lanes) and ::_fps_kernel (:97, one
// cloud per grid step). On a GPU the clouds run side by side, so one kernel
// covers both.
//
// Semantics: pick 0 is index 0; every later pick is the point with the
// largest running minimum squared distance to the picked set, the LOWEST
// index among equal values. Points past N are never read or picked.
//
// What bounds it: not bytes (B*N*12 in, B*n*4 out) and not operations (about
// 10*B*n*N), but the chain of n-1 DEPENDENT rounds, and inside a round, at
// large N, the instructions of the point update. The design before this one
// kept the points and minima in shared memory (five accesses a point and
// round) and reduced by shuffles (ten a level). Now:
//   - thread t of a cloud owns the points t, t+T, ... (P of them, P a
//     template parameter, T the threads a cloud) and keeps x, y, z and the
//     running minimum of each in registers for the whole loop: the loops over
//     P are unrolled, so nothing goes to local memory;
//   - a round's arg-max: the running minima are +0 or more (or +inf), so
//     their bits order them as integers. A warp takes __reduce_max_sync of
//     the bits, then __reduce_min_sync of the index over the lanes that hold
//     that maximum (0xffffffff elsewhere): the lowest index among equal
//     values, exactly. Where a cloud has several warps they write (value,
//     index) to slots, double-buffered by the round's parity, and after ONE
//     barrier every warp does the same two steps over the slots;
//   - the winner's coordinates come from a copy of the cloud in shared
//     memory, one broadcast read a round;
//   - one block a cloud; with one warp (T = 32) it needs no barrier at all.
//     Several clouds a block never won on the card (PERF.md §6);
//   - registers hold 8,192 points a block (P 8 at 1024 threads, 16 at 512,
//     32 at 256). A larger cloud (up to 14,496 points, as ModelNet40's raw
//     10,000) takes 1024 threads at P 16 with SHARED: the running minima stay
//     in registers and x, y, z are read from the cloud's copy in shared
//     memory, one conflict-free 16-byte read a point and round. (Keeping the
//     minimum in the copy's w as well costs a store a point, four-way bank
//     conflicted, and was no faster than the design before.)
// What bounds it now (ablations on an H100, PERF.md §6): at N 1024 the
// round's chain (the reductions, the barrier and the broadcast read: 80% of a
// launch, 0.27 us a round); at N 8192 the update of 32 points a thread (75%),
// with the chain after it, since every warp waits at the barrier. Only more
// SMs per cloud (a thread-block cluster) would shorten either.
//
// Rounding: the distance is written with __fmul_rn/__fadd_rn in the order
// (dx*dx + dy*dy) + dz*dz so that the compiler cannot contract it into FMAs;
// it is then bit-identical to the plain PyTorch version and the greedy
// selection picks the same indices.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Shared-memory accesses of the round loop, through a 32-bit address held in a
// register. Left to itself the compiler recomputes the buffer's address (a
// special-register read and three integer operations) and the output row's,
// inside every round's chain, behind branches: 20% of a round at N 1024 on an
// H100 (PERF.md §6).
__device__ __forceinline__ float4 lds_v4(unsigned a) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
    return v;
}

__device__ __forceinline__ int2 lds_v2(unsigned a) {
    int2 v;
    asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(a) : "memory");
    return v;
}

__device__ __forceinline__ void sts_v2(unsigned a, int2 v) {
    asm volatile("st.shared.v2.s32 [%0], {%1, %2};" :: "r"(a), "r"(v.x), "r"(v.y) : "memory");
}

// threads a block may have at P points a thread (registers: 65,536 an SM)
#define FPS_MAX_THREADS(P) ((P) >= 32 ? 256 : (P) >= 16 ? 512 : 1024)

template <int P, bool SHARED>
__global__ void __launch_bounds__(SHARED ? 1024 : FPS_MAX_THREADS(P))
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int N, int n) {
    extern __shared__ float4 pts[];  // the cloud, then the slots
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int W = T >> 5;
    const float* src = xyz + (size_t)blockIdx.x * N * 3;
    int* o = out + (size_t)blockIdx.x * n;
    asm volatile("" : "+l"(o));  // opaque from here on: kept in a register

    float x[SHARED ? 1 : P], y[SHARED ? 1 : P], z[SHARED ? 1 : P], m[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int i = t + T * p;
        if (i < N) {
            const float px = src[3 * i + 0], py = src[3 * i + 1], pz = src[3 * i + 2];
            if (!SHARED) {
                x[p] = px;
                y[p] = py;
                z[p] = pz;
            }
            m[p] = CUDART_INF_F;
            pts[i] = make_float4(px, py, pz, 0.0f);
        } else {
            if (!SHARED) x[p] = y[p] = z[p] = 0.0f;
            m[p] = -CUDART_INF_F;  // below every real minimum: never picked
        }
    }
    if (t == 0) o[0] = 0;
    __syncthreads();

    unsigned cloud = (unsigned)__cvta_generic_to_shared(pts);
    asm volatile("" : "+r"(cloud));  // the same
    const unsigned put = cloud + N * 16 + warp * 8;  // the slots, [2][W] int2
    const unsigned get = cloud + N * 16 + lane * 8;
    const unsigned own = cloud + 16 * t;  // SHARED: this thread's first point
    float4 w = lds_v4(cloud);
    for (int r = 1; r < n; ++r) {
        float bv = -1.0f;
        int bp = 0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            float px, py, pz;
            if (SHARED) {
                if (t + T * p >= N) continue;  // m[p] is -inf: never picked
                const float4 q = lds_v4(own + 16 * T * p);
                px = q.x, py = q.y, pz = q.z;
            } else {
                px = x[p], py = y[p], pz = z[p];
            }
            const float dx = __fsub_rn(px, w.x);
            const float dy = __fsub_rn(py, w.y);
            const float dz = __fsub_rn(pz, w.z);
            const float d = __fadd_rn(
                __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
            m[p] = fminf(m[p], d);
            // indices rise with p, so a strict test keeps the lowest
            if (m[p] > bv) {
                bv = m[p];
                bp = p;
            }
        }
        const int v = __float_as_int(bv);
        int best = __reduce_max_sync(FULL, v);
        int last = (int)__reduce_min_sync(FULL, v == best ? (unsigned)(t + T * bp) : FULL);
        if (W > 1) {
            const unsigned odd = (r & 1) * W * 8;
            if (lane == 0) sts_v2(put + odd, make_int2(best, last));
            __syncthreads();
            const int2 e = lane < W ? lds_v2(get + odd) : make_int2(INT_MIN, -1);
            best = __reduce_max_sync(FULL, e.x);
            last = (int)__reduce_min_sync(FULL, e.x == best ? (unsigned)e.y : FULL);
        }
        if (t == 0) o[r] = last;
        w = lds_v4(cloud + 16 * last);
    }
}

size_t smem_bytes(int N, int T) {
    return (size_t)N * sizeof(float4) + 2 * (size_t)(T / 32) * sizeof(int2);
}

template <int P, bool SHARED>
int launch(const void* xyz, void* out, int B, int N, int n, int T, cudaStream_t stream) {
    const size_t smem = smem_bytes(N, T);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fps_kernel<P, SHARED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    fps_kernel<P, SHARED><<<B, T, smem, stream>>>((const float*)xyz, (int*)out, N, n);
    return (int)cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) fp32 contiguous -> out (B, n) int32. A cloud's block has
// `threads` threads (a multiple of 32, at most 1024); a thread owns P =
// ceil(N / threads) points, rounded up to 1, 2, 4, 8, 16 or 32, and a block
// may have 1024 threads up to P 16 and 256 at P 32. A thread's points stay in
// registers up to 512 threads at P 16; at more, their x, y, z are read from
// shared memory (SHARED) and only the running minima stay. Returns the
// launch's cudaError_t (0 = success); a geometry the kernel does not take
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int gm3d_fps(const void* xyz, void* out, int B, int N, int n, int threads,
                        void* stream) {
    const int T = threads;
    if (B < 1 || N < 1 || n < 1 || T < 32 || T > 1024 || T % 32 != 0 ||
        smem_bytes(N, T) > 232448)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int need = (N + T - 1) / T;
    if (need <= 1) return launch<1, false>(xyz, out, B, N, n, T, s);
    if (need <= 2) return launch<2, false>(xyz, out, B, N, n, T, s);
    if (need <= 4) return launch<4, false>(xyz, out, B, N, n, T, s);
    if (need <= 8) return launch<8, false>(xyz, out, B, N, n, T, s);
    if (need <= 16)
        return T <= FPS_MAX_THREADS(16) ? launch<16, false>(xyz, out, B, N, n, T, s)
                                        : launch<16, true>(xyz, out, B, N, n, T, s);
    if (need <= 32 && T <= FPS_MAX_THREADS(32)) return launch<32, false>(xyz, out, B, N, n, T, s);
    return (int)cudaErrorInvalidValue;
}
