// K1: fused nearest neighbour (distance + running min/argmin) for Hopper.
//
// Replaces the Pallas TPU kernel _nn_kernel of
// poseestimator_tpu/geom3d/pallas_nn.py (launched by nn_pallas), with the
// wrapper's epilogue folded in: invalid data never wins (|b|^2 = 3e38), the
// winner's squared distance is recomputed exactly from the coordinates, and
// found = query_valid & best < 1.5e38 & any(data_valid).
//
// What bounds it on an H100: instruction issue and the fixed cost of a short
// launch, not memory. A 4096 x 4096 problem moves ~160 KB but evaluates
// 16.8 M pairs, and no tensor core may help: the cross term must not be
// rounded to TF32 or bf16 (mm-scale neighbours are lost). Each pair costs 7
// float32 instructions, none of which may fuse into an FMA (-fmad=false: the
// plain version must round alike), plus one to track the minimum, so the
// ceiling is the issue rate of single float32 instructions (132 SMs x 128
// lanes x 1.98 GHz = 33.5 T/s: 4.0 us at 4096^2), half the 67 TFLOP/s FMA
// peak. Data reach the lanes as float4 broadcasts from shared memory, which
// issue a quarter warp at a time, so a lane must use each one for several
// queries or shared memory, not the float32 pipes, sets the pace.
//
// Design (the numbers are the #defines below):
// * The data range is split three ways so that a 4096-query problem fills
//   the card with two blocks on each SM: across the NN_CLUSTER blocks of a
//   thread-block cluster (each a contiguous slice), across the NN_WARPS
//   warps of a block (each a contiguous part of every staged tile), and
//   across the NN_G lane groups of a warp (group g takes every NN_G-th point
//   of its warp's part, so the groups read neighbouring words). All groups
//   of a block share its NN_QB queries; a lane holds NN_Q of them in
//   registers, so each broadcast float4 feeds NN_Q pairs. At 4096 x 4096
//   that is 256 blocks of 8 warps: 128 clusters of two, which the hardware
//   spreads evenly over the SMs (larger clusters are placed a GPC at a time
//   and leave SMs idle).
// * Data stream through shared memory in tiles of NN_TILE points, staged
//   four points per thread with 16-byte loads as (-2x, -2y, -2z, |b|^2): the
//   factor 2 is folded into the data (scaling by a power of two is exact),
//   so a pair is
//       d2 = (q2 + b2) + ((qx*bx' + qy*by') + qz*bz'),
//   bit for bit the plain version's (q2 + b2) - 2*((qx*bx + qy*by) + qz*bz).
// * Minimum without a compare per pair: each group scans its points in
//   ascending index order in runs of NN_RUN, takes the run's minimum with
//   fminf, and keeps the run only when that minimum is strictly below its
//   best (so an equal value later never displaces an earlier one); only
//   then, in a branch the warp takes together, does it look for the first
//   point of the run equal to that minimum, among the distances still in
//   registers. So it keeps the lowest index of its minimum.
// * Merging: candidates (d2, idx) merge by the lexicographic minimum, across
//   the groups of a warp by shuffles, across the warps of a block in shared
//   memory, then across the blocks of the cluster: each block writes its
//   candidates into the shared memory of the block that finishes them
//   (NN_QB / NN_CLUSTER queries each: merge, exact recompute, found), and
//   one cluster barrier publishes them. A block may write into another's
//   shared memory only once that block has started: every thread arrives
//   on the cluster barrier (relaxed) at entry and waits on it just before
//   those stores, so the scan in between hides the wait. Merging compares
//   the float values and then the indices, so the lowest index wins every
//   tie and a negative d2 (the expanded form cancels below zero for
//   near-coincident points 0.5 m out) orders as a float: no integer key, no
//   atomics, no scratch and no second launch.
// * Batch axis (fused_nn_batched_launch: B problems of N queries against M
//   data points each, what the JAX package's vmap of nn_pallas computes in
//   one launch): problem b is blockIdx.y, and every pointer is offset to its
//   rows before anything else; the x axis and the cluster stay as above. So
//   a problem's arithmetic, and its any(data_valid), are those of an
//   unbatched launch on it. The result is the lexicographic minimum of
//   (d2, index) over the valid points, whatever the split, so padding a
//   problem with invalid points changes no bit; the wrapper pads M to a
//   multiple of 4 so that every problem's data keep the 16-byte alignment of
//   the staging loads.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NN_BIG 3.0e38f
#define NN_Q 4                      // queries per lane
#define NN_G 4                      // lane groups per warp, each scans its own data
#define NN_LG (32 / NN_G)           // lanes per group
#define NN_WARPS 8                  // warps per block, each scans its own data
#define NN_THREADS (NN_WARPS * 32)
#define NN_QB (NN_LG * NN_Q)        // queries per block, shared by all its groups
#define NN_CLUSTER 2                // blocks per cluster, each its own data slice
#define NN_RUN 4                    // points per fminf run of a group
#define NN_TILE 2048                // data points staged at a time
#define NN_STEP (NN_G * NN_RUN)     // points of one run of all groups of a warp
#define NN_ALIGN (NN_WARPS * NN_STEP)  // slice lengths are multiples of this

__device__ __forceinline__ float sq3(float x, float y, float z) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Stages points k .. k+3 of the tile that starts at data index t0 (n real
// points; later entries are +inf padding, which never wins) as
// (-2x, -2y, -2z, |b|^2 or 3e38 when invalid), with three 16-byte loads of
// coordinates and one 4-byte load of flags where all four are real (k and
// t0 are multiples of 4, the inputs 16-byte aligned). Returns whether any of
// them is valid.
__device__ __forceinline__ int stage4(const float* __restrict__ d,
                                      const uint8_t* __restrict__ dv, int t0, int k, int n,
                                      float4* tile) {
    const int j = t0 + k;
    float p[12];
    uint32_t flags = 0;
    if (k + 4 <= n) {
        const float4* s = reinterpret_cast<const float4*>(d + 3 * j);
        const float4 a = __ldg(s), b = __ldg(s + 1), c = __ldg(s + 2);
        const float v[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
        for (int e = 0; e < 12; ++e) p[e] = v[e];
        flags = __ldg(reinterpret_cast<const uint32_t*>(dv + j));
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const bool real = k + u < n;
#pragma unroll
            for (int e = 0; e < 3; ++e) p[3 * u + e] = real ? d[3 * (j + u) + e] : 0.f;
            flags |= real ? (uint32_t)dv[j + u] << (8 * u) : 0u;
        }
    }
    int any = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const float x = p[3 * u], y = p[3 * u + 1], z = p[3 * u + 2];
        const bool valid = (flags >> (8 * u)) & 0xffu;
        tile[k + u] = k + u < n ? make_float4(__fmul_rn(-2.0f, x), __fmul_rn(-2.0f, y),
                                              __fmul_rn(-2.0f, z), valid ? sq3(x, y, z) : NN_BIG)
                                : make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
        any |= valid;
    }
    return any;
}

__device__ __forceinline__ float pair_d2(float qx, float qy, float qz, float q2, float4 b) {
    const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, b.x), __fmul_rn(qy, b.y)),
                                  __fmul_rn(qz, b.z));
    return __fadd_rn(__fadd_rn(q2, b.w), cross);
}

// (d, i) < (bd, bi) lexicographically
__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
    return d < bd || (d == bd && i < bi);
}

__global__ void __cluster_dims__(NN_CLUSTER, 1, 1) __launch_bounds__(NN_THREADS)
fused_nn_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qv, int N,
                const float* __restrict__ d, const uint8_t* __restrict__ dv, int M,
                float* __restrict__ out_dist, long long* __restrict__ out_idx,
                uint8_t* __restrict__ out_found) {
    constexpr int kPer = NN_QB / NN_CLUSTER;  // queries each block finishes
    {  // this block's problem of the batch
        const size_t b = blockIdx.y;
        q += b * N * 3;
        qv += b * N;
        d += b * M * 3;
        dv += b * M;
        out_dist += b * N;
        out_idx += b * N;
        out_found += b * N;
    }
    __shared__ float4 tile[NN_TILE];
    __shared__ float cand_d[NN_WARPS][NN_QB];
    __shared__ int cand_i[NN_WARPS][NN_QB];
    __shared__ float recv_d[NN_CLUSTER][kPer];  // written by every block of the cluster
    __shared__ int recv_i[NN_CLUSTER][kPer];
    __shared__ int recv_any[NN_CLUSTER];

    // this block has started: the others may write into its shared memory
    // once every block of the cluster has arrived (waited on below)
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int q0 = (blockIdx.x / NN_CLUSTER) * NN_QB;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int grp = lane / NN_LG, u = lane % NN_LG;

    float qx[NN_Q], qy[NN_Q], qz[NN_Q], q2[NN_Q], best[NN_Q];
    int bidx[NN_Q];
#pragma unroll
    for (int c = 0; c < NN_Q; ++c) {
        const int i = q0 + u + NN_LG * c;
        qx[c] = qy[c] = qz[c] = 0.f;
        if (i < N) {
            qx[c] = q[3 * i];
            qy[c] = q[3 * i + 1];
            qz[c] = q[3 * i + 2];
        }
        q2[c] = sq3(qx[c], qy[c], qz[c]);
        best[c] = NN_BIG;
        bidx[c] = 0;
    }

    // this block's slice [s0, s1) of the data
    const int slice = (M + NN_CLUSTER * NN_ALIGN - 1) / (NN_CLUSTER * NN_ALIGN) * NN_ALIGN;
    const int s0 = min(M, rank * slice), s1 = min(M, s0 + slice);
    int any_valid = 0;
    for (int t0 = s0; t0 < s1; t0 += NN_TILE) {
        const int n = min(NN_TILE, s1 - t0);
        const int per_warp = (n + NN_ALIGN - 1) / NN_ALIGN * NN_STEP;
        // staged 4 points at a time; the blocks that share a slice start at
        // different places, so they do not all ask the same L2 lines at once
        const int quads = per_warp * NN_WARPS / 4;
        const int steps = (quads + NN_THREADS - 1) / NN_THREADS;
        const int rot = (int)(blockIdx.x / NN_CLUSTER) % steps;
        int mine = 0;
#pragma unroll 2
        for (int st = 0; st < steps; ++st) {
            const int g = (st + rot) % steps * NN_THREADS + (int)threadIdx.x;
            if (g < quads) mine |= stage4(d, dv, t0, 4 * g, n, tile);
        }
        any_valid |= __syncthreads_or(mine);
        const int lo = warp * per_warp;
        for (int k = lo; k < lo + per_warp; k += NN_STEP) {
            // group g takes points k + g, k + g + G, ...: ascending, and the
            // groups of a warp read neighbouring words
            float4 b[NN_RUN];
#pragma unroll
            for (int r = 0; r < NN_RUN; ++r) b[r] = tile[k + r * NN_G + grp];
            float v[NN_RUN][NN_Q], m[NN_Q];
            bool beat = false;
#pragma unroll
            for (int c = 0; c < NN_Q; ++c) {
#pragma unroll
                for (int r = 0; r < NN_RUN; ++r) {
                    v[r][c] = pair_d2(qx[c], qy[c], qz[c], q2[c], b[r]);
                    m[c] = r == 0 ? v[r][c] : fminf(m[c], v[r][c]);
                }
                beat |= m[c] < best[c];
            }
            // a run that beats a best: its first point equal to the run's
            // minimum, taken while the distances are still in registers
            if (__any_sync(0xffffffffu, beat)) {
#pragma unroll
                for (int c = 0; c < NN_Q; ++c) {
                    if (m[c] < best[c]) {
                        int pos = NN_RUN - 1;
#pragma unroll
                        for (int r = NN_RUN - 2; r >= 0; --r) pos = v[r][c] == m[c] ? r : pos;
                        best[c] = m[c];
                        bidx[c] = t0 + k + pos * NN_G + grp;
                    }
                }
            }
        }
        __syncthreads();  // the next tile overwrites this one
    }

#pragma unroll
    for (int c = 0; c < NN_Q; ++c) {
#pragma unroll
        for (int off = NN_LG; off < 32; off *= 2) {  // merge the groups of the warp
            const float od = __shfl_xor_sync(0xffffffffu, best[c], off);
            const int oi = __shfl_xor_sync(0xffffffffu, bidx[c], off);
            if (lex_less(od, oi, best[c], bidx[c])) {
                best[c] = od;
                bidx[c] = oi;
            }
        }
        if (grp == 0) {
            cand_d[warp][u + NN_LG * c] = best[c];
            cand_i[warp][u + NN_LG * c] = bidx[c];
        }
    }
    __syncthreads();
    asm volatile("barrier.cluster.wait;" ::: "memory");  // every block has started
    if (threadIdx.x < NN_QB) {
        // merge the warps, then send the block's candidate to the block of the
        // cluster that finishes this query
        float bd = cand_d[0][threadIdx.x];
        int bi = cand_i[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < NN_WARPS; ++w) {
            const float od = cand_d[w][threadIdx.x];
            const int oi = cand_i[w][threadIdx.x];
            if (lex_less(od, oi, bd, bi)) {
                bd = od;
                bi = oi;
            }
        }
        const int owner = threadIdx.x / kPer, slot = threadIdx.x % kPer;
        cluster.map_shared_rank(&recv_d[0][0], owner)[rank * kPer + slot] = bd;
        cluster.map_shared_rank(&recv_i[0][0], owner)[rank * kPer + slot] = bi;
    }
    if (threadIdx.x < NN_CLUSTER) cluster.map_shared_rank(recv_any, (int)threadIdx.x)[rank] = any_valid;
    // this block finishes queries q0 + rank * kPer + [0, kPer): read them
    // before the barrier
    const int i = q0 + rank * kPer + (int)threadIdx.x;
    const bool fin = threadIdx.x < kPer && i < N;
    float ex = 0.f, ey = 0.f, ez = 0.f;
    bool eqv = false;
    if (fin) {
        ex = q[3 * i];
        ey = q[3 * i + 1];
        ez = q[3 * i + 2];
        eqv = qv[i] != 0;
    }
    cluster.sync();  // every block's candidates have arrived; none is sent later

    if (fin) {
        float bd = NN_BIG;
        int bi = 0, any = 0;
#pragma unroll
        for (int p = 0; p < NN_CLUSTER; ++p) {
            any |= recv_any[p];
            if (lex_less(recv_d[p][threadIdx.x], recv_i[p][threadIdx.x], bd, bi)) {
                bd = recv_d[p][threadIdx.x];
                bi = recv_i[p][threadIdx.x];
            }
        }
        const bool found = eqv && (bd < 0.5f * NN_BIG) && (any != 0);
        // exact recompute of the winning pair: the expanded form above
        // cancels catastrophically at mm scale, so it only selects
        const float dx = __fsub_rn(ex, d[3 * bi]);
        const float dy = __fsub_rn(ey, d[3 * bi + 1]);
        const float dz = __fsub_rn(ez, d[3 * bi + 2]);
        out_dist[i] = found ? sqrtf(sq3(dx, dy, dz)) : 0.f;
        out_idx[i] = (long long)bi;
        out_found[i] = found ? 1 : 0;
    }
}

extern "C" int fused_nn_batched_launch(const void* q, const void* qv, int N,
                                       const void* d, const void* dv, int M, int B,
                                       void* out_dist, void* out_idx, void* out_found,
                                       void* stream) {
    if (N > 0 && M > 0 && B > 0) {
        const dim3 grid((N + NN_QB - 1) / NN_QB * NN_CLUSTER, B);
        fused_nn_kernel<<<grid, NN_THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)q, (const uint8_t*)qv, N, (const float*)d,
            (const uint8_t*)dv, M, (float*)out_dist, (long long*)out_idx,
            (uint8_t*)out_found);
    }
    return (int)cudaGetLastError();
}

extern "C" int fused_nn_launch(const void* q, const void* qv, int N,
                               const void* d, const void* dv, int M,
                               void* out_dist, void* out_idx, void* out_found,
                               void* stream) {
    return fused_nn_batched_launch(q, qv, N, d, dv, M, 1, out_dist, out_idx, out_found,
                                   stream);
}
