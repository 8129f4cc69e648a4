// K1: fused nearest neighbour (distance + running min/argmin) for Hopper.
//
// Replaces the Pallas TPU kernel _nn_kernel of
// poseestimator_tpu/geom3d/pallas_nn.py (launched by nn_pallas), with the
// wrapper's epilogue folded in: invalid data never wins (|b|^2 = 3e38), the
// winner's squared distance is recomputed exactly from the coordinates, and
// found = query_valid & best < 1.5e38 & any(data_valid).
//
// What bounds it on an H100: arithmetic, not memory. Each query-data pair
// costs 8 float32 operations (3 mul + 2 add for the cross term, one add,
// one mul, one sub) plus the compare; a 4096 x 4096 problem moves ~160 KB
// but does ~0.15 GOP, and no tensor core may help: the cross term must not be
// rounded to TF32 or bf16 (mm-scale neighbours are lost), so the bound is
// the 67 TFLOP/s non-tensor float32 rate.
//
// Design: one thread per query, BLOCK queries per block. The data cloud is
// staged through shared memory in tiles of TILE points as float4
// (x, y, z, |b|^2), so each data point is read from device memory once per
// block and broadcast from shared memory to every thread; larger clouds
// (Chamfer at 16k) stream through tile by tile. Each thread keeps its running
// min and argmin in registers. The distance is the FMA-free expression of
// the plain PyTorch version, in the same order,
//     d2 = (q2 + b2) - 2 * ((qx*bx + qy*by) + qz*bz),
// spelled with __fmul_rn/__fadd_rn (and the file is built with -fmad=false),
// and the scan is in ascending index order with a strict '<', so ties keep
// the lowest index exactly as jnp.argmin / torch.min do.
#include <cuda_runtime.h>
#include <stdint.h>

#define NN_BIG 3.0e38f
#define NN_TILE 2048
#define NN_BLOCK 128

__device__ __forceinline__ float sq3(float x, float y, float z) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(NN_BLOCK)
fused_nn_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qv, int N,
                const float* __restrict__ d, const uint8_t* __restrict__ dv, int M,
                float* __restrict__ out_dist, long long* __restrict__ out_idx,
                uint8_t* __restrict__ out_found) {
    __shared__ float4 tile[NN_TILE];
    const int i = blockIdx.x * NN_BLOCK + threadIdx.x;
    const bool active = i < N;
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (active) {
        qx = q[3 * i];
        qy = q[3 * i + 1];
        qz = q[3 * i + 2];
    }
    const float q2 = sq3(qx, qy, qz);
    float best = NN_BIG;
    int bidx = 0;
    int any_valid = 0;

    for (int base = 0; base < M; base += NN_TILE) {
        const int n = min(NN_TILE, M - base);
        int mine = 0;
        for (int k = threadIdx.x; k < n; k += NN_BLOCK) {
            const int j = base + k;
            const float x = d[3 * j], y = d[3 * j + 1], z = d[3 * j + 2];
            const bool v = dv[j] != 0;
            tile[k] = make_float4(x, y, z, v ? sq3(x, y, z) : NN_BIG);
            mine |= v;
        }
        any_valid |= __syncthreads_or(mine);
        if (active) {
#pragma unroll 8
            for (int k = 0; k < n; ++k) {
                const float4 b = tile[k];
                const float cross = __fadd_rn(
                    __fadd_rn(__fmul_rn(qx, b.x), __fmul_rn(qy, b.y)), __fmul_rn(qz, b.z));
                const float d2 = __fsub_rn(__fadd_rn(q2, b.w), __fmul_rn(2.0f, cross));
                if (d2 < best) {
                    best = d2;
                    bidx = base + k;
                }
            }
        }
        __syncthreads();
    }

    if (active) {
        const bool found = (qv[i] != 0) && (best < 0.5f * NN_BIG) && (any_valid != 0);
        // exact recompute of the winning pair: the expanded form above
        // cancels catastrophically at mm scale, so it only selects
        const float dx = __fsub_rn(qx, d[3 * bidx]);
        const float dy = __fsub_rn(qy, d[3 * bidx + 1]);
        const float dz = __fsub_rn(qz, d[3 * bidx + 2]);
        out_dist[i] = found ? sqrtf(sq3(dx, dy, dz)) : 0.f;
        out_idx[i] = (long long)bidx;
        out_found[i] = found ? 1 : 0;
    }
}

extern "C" int fused_nn_launch(const void* q, const void* qv, int N,
                               const void* d, const void* dv, int M,
                               void* out_dist, void* out_idx, void* out_found,
                               void* stream) {
    if (N > 0 && M > 0) {
        const dim3 grid((N + NN_BLOCK - 1) / NN_BLOCK);
        fused_nn_kernel<<<grid, NN_BLOCK, 0, (cudaStream_t)stream>>>(
            (const float*)q, (const uint8_t*)qv, N, (const float*)d,
            (const uint8_t*)dv, M, (float*)out_dist, (long long*)out_idx,
            (uint8_t*)out_found);
    }
    return (int)cudaGetLastError();
}
