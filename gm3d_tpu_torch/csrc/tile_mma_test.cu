// One block, one product through tile_mma.cuh, written out through for_frag:
// the unit check of the tensor-core tile product, so that a wrong fragment
// map, panel layout or copy shows in one 64 x 64 tile and not inside the
// attention kernels. ops/tile_mma.py::tile_product launches it; it is on no
// model's path.

#include <type_traits>

#include "tile_mma.cuh"

namespace {

using namespace gm3d;

constexpr int LD = TILE + 8;  // the attention kernels' shared-memory row

// P(t, k) for t < rows, k < K <= TILE into a zeroed (64, 72) buffer in layout
// LAY, as the attention kernels hold their DIRECT operands; returns its strides.
template <Layout LAY, typename T>
__device__ void to_shared(float* buf, const T* P, long s_t, long s_k, int rows, int K,
                          long& o_t, long& o_k) {
    o_t = LAY == TK ? LD : 1;
    o_k = LAY == TK ? 1 : LD;
    for (int e = threadIdx.x; e < TILE * LD; e += THREADS) buf[e] = 0.0f;
    __syncthreads();
    for (int e = threadIdx.x; e < rows * K; e += THREADS) {
        const int t = e / K, k = e % K;
        buf[t * o_t + k * o_k] = to_float(P[t * s_t + k * s_k]);
    }
}

template <typename T, Layout LA, bool DA, Layout LB, bool DB, bool CHAIN>
__global__ void __launch_bounds__(THREADS)
tile_mma_test_kernel(const T* A, long sa_i, long sa_k, int M, const T* B, long sb_k, long sb_j,
                     int N, int K, float* out) {
    extern __shared__ __align__(16) float smem[];
    float* stage = smem;
    float* bufA = smem + MMA_STAGE_FLOATS;
    float* bufB = bufA + TILE * LD;
    float acc[4][4];
    zero(acc);
    long a_i = sa_i, a_k = sa_k, b_j = sb_j, b_k = sb_k;
    if (DA) to_shared<LA>(bufA, A, sa_i, sa_k, M, K, a_i, a_k);
    if (DB) to_shared<LB>(bufB, B, sb_j, sb_k, N, K, b_j, b_k);
    using OpA = typename std::conditional<DA, float, T>::type;
    using OpB = typename std::conditional<DB, float, T>::type;
    tile_mma<LA, DA, LB, DB, CHAIN>(
        acc, DA ? reinterpret_cast<const OpA*>(bufA) : reinterpret_cast<const OpA*>(A), a_i, a_k,
        M, DB ? reinterpret_cast<const OpB*>(bufB) : reinterpret_cast<const OpB*>(B), b_k, b_j,
        N, K, stage);
    for_frag(acc, M, N, [&](int i, int j, float v) { out[i * N + j] = v; });
}

struct Args {
    const void *A, *B;
    long sa_i, sa_k, sb_k, sb_j;
    int M, N, K;
    float* out;
    cudaStream_t stream;
};

template <typename T, Layout LA, bool DA, Layout LB, bool DB, bool CHAIN = false>
int launch(const Args& a) {
    const int smem = (MMA_STAGE_FLOATS + 2 * TILE * LD) * (int)sizeof(float);
    auto kernel = tile_mma_test_kernel<T, LA, DA, LB, DB, CHAIN>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<1, THREADS, smem, a.stream>>>((const T*)a.A, a.sa_i, a.sa_k, a.M, (const T*)a.B,
                                           a.sb_k, a.sb_j, a.N, a.K, a.out);
    return (int)cudaGetLastError();
}

// an operand's layout is where its unit stride is (TK when neither is 1: the
// panel copy then goes element by element)
template <typename T, bool DA, bool DB>
int by_layout(const Args& a) {
    const bool a_kt = a.sa_i == 1 && a.sa_k != 1, b_kt = a.sb_j == 1 && a.sb_k != 1;
    if (a_kt) return b_kt ? launch<T, KT, DA, KT, DB>(a) : launch<T, KT, DA, TK, DB>(a);
    return b_kt ? launch<T, TK, DA, KT, DB>(a) : launch<T, TK, DA, TK, DB>(a);
}

template <typename T>
int by_source(const Args& a, int shared) {
    switch (shared & 3) {
        case 0: return by_layout<T, false, false>(a);
        case 1: return by_layout<T, true, false>(a);
        case 2: return by_layout<T, false, true>(a);
        default: return by_layout<T, true, true>(a);
    }
}

}  // namespace

// out (M, N) fp32 contiguous = A B with A(i, k) = A[i*sa_i + k*sa_k] (M, K) and
// B(k, j) = B[k*sb_k + j*sb_j] (K, N), M, N <= 64; both fp32, or both bf16
// (`bf16` != 0). `shared` bit 0 (bit 1) first copies A (B) into a padded fp32
// shared-memory buffer and multiplies from there, as the attention kernels do
// with q, k, v and the scores (then K <= 64). `chain` != 0 (fp32 from device
// memory, both with unit stride in k) sums all of K through one chain of mma
// accumulators, which the kernels do not. Returns the launch's cudaError_t
// (0 = success).
extern "C" int gm3d_tile_mma_test(const void* A, long sa_i, long sa_k, int M, const void* B,
                                  long sb_k, long sb_j, int N, int K, void* out, int bf16,
                                  int shared, int chain, void* stream) {
    if (M < 1 || N < 1 || K < 1 || M > TILE || N > TILE || (shared && K > TILE) ||
        (chain && (bf16 || shared || sa_k != 1 || sb_k != 1)))
        return (int)cudaErrorInvalidValue;
    const Args a{A, B, sa_i, sa_k, sb_k, sb_j, M, N, K, (float*)out, (cudaStream_t)stream};
    if (chain) return launch<float, TK, false, TK, false, true>(a);
    return bf16 ? by_source<__nv_bfloat16>(a, shared) : by_source<float>(a, shared);
}
