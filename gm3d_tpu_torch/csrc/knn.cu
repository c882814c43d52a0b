// Exact k-nearest-neighbour search for Hopper (sm_90a): a threshold, a
// candidate sort, and k rounds of selection only where the candidates
// overflow.
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
// What bounds it: neither bytes (B*N*12 + B*G*12 in, B*G*k*8 out; the
// (B, G, N) distance matrix never reaches device memory) nor operations
// (about 9*B*G*N), but the instructions a warp issues for its query. The
// design before this one spent most of them on k rounds in which one lane
// rescanned its N/32 distances while the rest of the warp waited. Now:
//   - a block works on one cloud and a tile of its queries: it stages x, y,
//     z and r2 of the cloud once in shared memory (one 16-byte read a point
//     after that) where that leaves room for four warps, and its warps take
//     the tile's queries one at a time;
//   - lane l owns the points l, l+32, ...: it writes their distances, as
//     order-preserving 32-bit keys, into the warp's row of shared memory and
//     keeps the minimum of each of its R runs (slot j belongs to run j % R);
//   - tau, the k-th smallest of the warp's 32*R run minima (a bitonic sort
//     across the warp), bounds the answer: at least k points lie at or below
//     it, so the k nearest are among them. Those candidates are compacted
//     (ballot + popc) into a 128-entry buffer of (key, index) pairs, sorted
//     there (bitonic, one, two or four a lane, as few as hold them), and the
//     first k are written out;
//   - where more than 128 points lie at or below tau (many points tie at it:
//     identical points, grids) or k > 128, the query takes k rounds of
//     arg-min over its row, each one redux.sync on the key and one on the
//     index, and is counted in `overflow`. The answer is the same.
// R is chosen by the wrapper so that 32*R >= 2k: more runs make tau tighter
// and the candidates fewer, at the price of a longer sort for tau. At k 32,
// R 2 (a sort of 64 keys) is 7% faster than R 4 and leaves up to 66
// candidates on standard-normal clouds: hence 128 entries, not 64.
// What bounds it now (ablations on an H100, PERF.md §6): the distance pass,
// half of a launch at N 1024 and 2048, issue-bound; staging the cloud saves a
// sixth against reading it from L2 in that pass; the candidate sort is a tenth.
// Staging is a template flag: where it would leave fewer than four warps a
// block (the cloud's 16 bytes a point beside each warp's row of 4; N above
// about 7,000, as finetuning's 8,192-point clouds), the wrapper launches the
// kernel that reads the cloud from L2 and recomputes r2 in the distance pass,
// so that the rows of three times as many warps fit.
//
// Rounding: products and sums are written with __fmul_rn/__fadd_rn in the
// order of the plain PyTorch version (cross summed x, y, z) so that no FMA is
// formed and both choose the same neighbours. r2 is computed once per point
// in the same order.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CAP = 128;                // a warp's candidate buffer, four a lane
constexpr unsigned NONE = 0xffffffffu;  // a key above every distance, +inf included
constexpr int MAX_WARPS = 16;

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                     __fmul_rn(az, bz));
}

// Order-preserving key: a < b <=> key(a) < key(b) and a == b <=> key(a) ==
// key(b). Positive floats get the sign bit set, negative ones are inverted.
// Adding +0 maps -0.0 to +0.0 (round to nearest) and leaves every other value
// as it is. The distance never is -0.0 anyway: r2 and q2 are sums of squares
// (>= +0, never -0), q2 - 2*cross is -0 only when q2 is -0, and a sum is -0
// only when both terms are. Slightly negative distances do occur (the query
// is one of the points) and order correctly.
__device__ __forceinline__ unsigned ordered_key(float d) {
    const unsigned bits = __float_as_uint(__fadd_rn(d, 0.0f));
    return bits ^ ((unsigned)((int)bits >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
    return __uint_as_float(key ^ ((key & 0x80000000u) ? 0x80000000u : 0xffffffffu));
}

// Sorts the warp's 32*E values ascending: element s*32 + lane is v[s] of that
// lane. A bitonic network: strides below 32 cross lanes by shuffles, larger
// ones stay inside a lane.
template <int E, typename T>
__device__ __forceinline__ void warp_sort(T (&v)[E], int lane) {
#pragma unroll
    for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            if (stride >= 32) {
#pragma unroll
                for (int s = 0; s < E; ++s) {
                    const int t = s ^ (stride >> 5);
                    if (t > s) {
                        const bool up = ((s * 32) & size) == 0;
                        const T a = v[s], b = v[t];
                        const bool swap = up ? (b < a) : (a < b);
                        v[s] = swap ? b : a;
                        v[t] = swap ? a : b;
                    }
                }
            } else {
#pragma unroll
                for (int s = 0; s < E; ++s) {
                    const T o = __shfl_xor_sync(FULL, v[s], stride);
                    const bool up = ((s * 32 + lane) & size) == 0;
                    const bool lower = (lane & stride) == 0;
                    const bool smaller = o < v[s];
                    // the lower element of an ascending pair keeps the minimum
                    v[s] = (lower == up) == smaller ? o : v[s];
                }
            }
        }
    }
}

// The k-th smallest (k <= 32*E) of the warp's values, on every lane.
template <int E>
__device__ __forceinline__ unsigned warp_kth(unsigned (&v)[E], int k, int lane) {
    warp_sort<E>(v, lane);
    const int e = k - 1;
    unsigned mine = v[0];
#pragma unroll
    for (int s = 1; s < E; ++s)
        if (s == (e >> 5)) mine = v[s];
    return __shfl_sync(FULL, mine, e & 31);
}

template <int E>
__device__ __forceinline__ void sort_and_write(const unsigned long long* cand, int count,
                                               int k, int lane, int* oi, float* od) {
    unsigned long long c[E];
#pragma unroll
    for (int s = 0; s < E; ++s)
        c[s] = s * 32 + lane < count ? cand[s * 32 + lane] : ~0ull;
    warp_sort<E>(c, lane);
#pragma unroll
    for (int s = 0; s < E; ++s) {
        const int e = s * 32 + lane;
        if (e < k) {
            oi[e] = (int)(unsigned)c[s];
            od[e] = key_value((unsigned)(c[s] >> 32));
        }
    }
}

template <int R, bool STAGED>
__global__ void __launch_bounds__(MAX_WARPS * 32)
knn_kernel(const float* __restrict__ ref, const float* __restrict__ query,
           int* __restrict__ out_idx, float* __restrict__ out_dist,
           unsigned long long* __restrict__ overflow, int N, int G, int k,
           int queries_per_block) {
    extern __shared__ float4 smem[];
    const int warps = blockDim.x >> 5;
    float4* cloud = smem;  // STAGED: N x (x, y, z, r2)
    unsigned long long* cands =
        reinterpret_cast<unsigned long long*>(cloud + (STAGED ? N : 0));  // warps x CAP
    unsigned* rows = reinterpret_cast<unsigned*>(cands + warps * CAP);  // warps x N keys
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.y;

    const float* r = ref + (size_t)b * N * 3;
    if (STAGED) {
        for (int i = threadIdx.x; i < N; i += blockDim.x) {
            const float x = r[3 * i + 0], y = r[3 * i + 1], z = r[3 * i + 2];
            cloud[i] = make_float4(x, y, z, dot3(x, y, z, x, y, z));
        }
        __syncthreads();  // the only block barrier: from here on each warp is alone
    }

    unsigned* row = rows + (size_t)warp * N;
    unsigned long long* cand = cands + warp * CAP;
    const unsigned below = (1u << lane) - 1u;
    const int g_end = min(G, (blockIdx.x + 1) * queries_per_block);
    for (int g = blockIdx.x * queries_per_block + warp; g < g_end; g += warps) {
        const float* q = query + ((size_t)b * G + g) * 3;
        const float qx = q[0], qy = q[1], qz = q[2];
        const float q2 = dot3(qx, qy, qz, qx, qy, qz);
        int* oi = out_idx + ((size_t)b * G + g) * k;
        float* od = out_dist + ((size_t)b * G + g) * k;

        // distances, keys and the run minima
        unsigned run[R];
#pragma unroll
        for (int s = 0; s < R; ++s) run[s] = NONE;
        for (int j0 = 0; j0 * 32 < N; j0 += R) {
#pragma unroll
            for (int s = 0; s < R; ++s) {
                const int i = lane + 32 * (j0 + s);
                if (i < N) {
                    float4 p;
                    if (STAGED) {
                        p = cloud[i];
                    } else {
                        const float x = r[3 * i + 0], y = r[3 * i + 1], z = r[3 * i + 2];
                        p = make_float4(x, y, z, dot3(x, y, z, x, y, z));
                    }
                    const float cross = dot3(qx, qy, qz, p.x, p.y, p.z);
                    const unsigned key = ordered_key(
                        __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, cross)), p.w));
                    row[i] = key;
                    run[s] = min(run[s], key);
                }
            }
        }

        // the candidates: every point at or below tau
        int count = CAP + 1;
        if (k <= CAP) {
            const unsigned tau = warp_kth<R>(run, k, lane);
            count = 0;
            for (int i0 = 0; i0 < N && count <= CAP; i0 += 32) {
                const int i = i0 + lane;
                const unsigned key = i < N ? row[i] : NONE;
                const bool take = key <= tau;
                const unsigned mask = __ballot_sync(FULL, take);
                const int pos = count + __popc(mask & below);
                if (take && pos < CAP)
                    cand[pos] = ((unsigned long long)key << 32) | (unsigned)i;
                count += __popc(mask);
            }
            __syncwarp();
        }

        if (count <= 32) {
            sort_and_write<1>(cand, count, k, lane, oi, od);
        } else if (count <= 64) {
            sort_and_write<2>(cand, count, k, lane, oi, od);
        } else if (count <= CAP) {
            sort_and_write<4>(cand, count, k, lane, oi, od);
        } else {
            // overflow: k rounds of arg-min over the row; the lane that owns
            // the winner masks it and rescans its own points
            if (lane == 0 && overflow != nullptr) atomicAdd(overflow, 1ull);
            unsigned best = NONE, at = NONE;
            for (int i = lane; i < N; i += 32) {
                const unsigned key = row[i];
                if (key < best) {  // indices rise within a lane: the first stays
                    best = key;
                    at = (unsigned)i;
                }
            }
            for (int j = 0; j < k; ++j) {
                const unsigned m = __reduce_min_sync(FULL, best);
                const unsigned w = __reduce_min_sync(FULL, best == m ? at : NONE);
                if (lane == 0) {
                    oi[j] = (int)w;
                    od[j] = key_value(m);
                }
                if ((w & 31u) == (unsigned)lane) {
                    row[w] = NONE;
                    best = NONE;
                    at = NONE;
                    for (int i = lane; i < N; i += 32) {
                        const unsigned key = row[i];
                        if (key < best) {
                            best = key;
                            at = (unsigned)i;
                        }
                    }
                }
            }
        }
        __syncwarp();  // the buffer and the row are free for the next query
    }
}

size_t smem_bytes(int N, int warps, bool staged) {
    return (staged ? (size_t)N * sizeof(float4) : 0) + (size_t)warps * CAP * 8 +
           (size_t)warps * N * 4;
}

template <int R, bool STAGED>
int launch(const void* ref, const void* query, void* idx, void* dist, void* overflow,
           int B, int N, int G, int k, int warps, int queries_per_block, cudaStream_t stream) {
    const size_t smem = smem_bytes(N, warps, STAGED);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            knn_kernel<R, STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid((G + queries_per_block - 1) / queries_per_block, B);
    knn_kernel<R, STAGED><<<grid, warps * 32, smem, stream>>>(
        (const float*)ref, (const float*)query, (int*)idx, (float*)dist,
        (unsigned long long*)overflow, N, G, k, queries_per_block);
    return (int)cudaGetLastError();
}

template <int R>
int launch_runs(const void* ref, const void* query, void* idx, void* dist, void* overflow,
                int B, int N, int G, int k, int warps, int queries_per_block, bool staged,
                cudaStream_t stream) {
    return staged ? launch<R, true>(ref, query, idx, dist, overflow, B, N, G, k, warps,
                                    queries_per_block, stream)
                  : launch<R, false>(ref, query, idx, dist, overflow, B, N, G, k, warps,
                                     queries_per_block, stream);
}

}  // namespace

// ref (B, N, 3), query (B, G, 3) fp32 contiguous -> idx (B, G, k) int32,
// dist (B, G, k) fp32. `overflow` (one uint64 on the device, or null) gains
// one for every query that took the k-round selection. A block holds one
// cloud and `queries_per_block` of its queries, taken by `warps` warps (1 to
// 16); `runs` (1, 2, 4 or 8, with 32*runs >= k where k <= 128) is R above;
// `staged` (0 or 1) copies the cloud into shared memory first.
// Returns the launch's cudaError_t (0 = success); a geometry the kernel does
// not take returns cudaErrorInvalidValue and launches nothing.
extern "C" int gm3d_knn(const void* ref, const void* query, void* idx, void* dist,
                        void* overflow, int B, int N, int G, int k, int warps,
                        int queries_per_block, int runs, int staged, void* stream) {
    if (N < 1 || k < 1 || k > N || warps < 1 || warps > MAX_WARPS || queries_per_block < 1 ||
        B > 65535 || (staged != 0 && staged != 1) || smem_bytes(N, warps, staged) > 232448 ||
        (k <= CAP && 32 * runs < k))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const bool st = staged == 1;
    switch (runs) {
        case 1: return launch_runs<1>(ref, query, idx, dist, overflow, B, N, G, k, warps, queries_per_block, st, s);
        case 2: return launch_runs<2>(ref, query, idx, dist, overflow, B, N, G, k, warps, queries_per_block, st, s);
        case 4: return launch_runs<4>(ref, query, idx, dist, overflow, B, N, G, k, warps, queries_per_block, st, s);
        case 8: return launch_runs<8>(ref, query, idx, dist, overflow, B, N, G, k, warps, queries_per_block, st, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
