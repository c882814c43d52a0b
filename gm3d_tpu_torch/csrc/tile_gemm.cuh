// What the kernels of this directory whose bodies are chains of small matrix
// products (patch_embed.cu, fused_attention.cu) share beside the product
// itself, which is tile_mma.cuh::tile_mma: the block's shape and the
// conversions of an operand's element type.
//
// A block of THREADS threads owns one output tile of at most TILE x TILE and
// walks the depth of a product KTILE at a time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gm3d {

constexpr int THREADS = 256;
constexpr int TILE = 64;
constexpr int KTILE = 32;

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

}  // namespace gm3d
