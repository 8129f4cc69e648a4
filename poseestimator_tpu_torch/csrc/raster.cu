// K2: triangle z-buffer (max of 1/z over covering faces) for Hopper.
//
// Replaces the Pallas TPU kernel _raster_kernel of
// poseestimator_tpu/render/raster.py (launched by _render_pallas). Inputs are
// the per-face setup of face_coeffs: coef (F, 12) float32 — the planes
// (a, b, c) of the three normalized barycentrics, then the 1/z plane — and
// bbox (F, 4) = (xmin, xmax, ymin, ymax) in window pixels, with the window
// origin already folded in. Output izmax (H, W) float32: -1 where no face
// covers the pixel. Both inputs must be 16-byte aligned (the wrapper sees to
// it).
//
// What bounds it on an H100: with the bbox cull, the work is the pixels that
// each face's bbox overlaps times ~20 float32 operations (four planes at two
// mul + two add, three compares, a max); bytes are 64 per face plus 4 per
// pixel. At the tracking window (128 x 128 px, 256 padded faces of which 12
// are real) both bounds are far below a microsecond, so a launch is bound by
// its fixed cost. At a 4096-face mesh over a 320 x 240 frame the shading is
// still small (a face covers a few pixels); what costs is culling every face
// against every tile.
//
// Design: one warp per 8 x 8 pixel tile, so a 128 x 128 window is 256 blocks
// and a 320 x 240 frame 1200, and no block-wide barrier is ever needed. Each
// lane shades two horizontally adjacent pixels, which share the b*Y product
// of every plane, and keeps a face's 12 coefficients in registers for both.
// Faces are culled RS_STEP at a time, RS_FPL per lane:
// * their bboxes arrive through a ring of RS_STAGES steps of cp.async copies
//   (each lane copies and reads its own 16-byte rows), so the loads of the
//   next steps are in flight while this one is tested;
// * each lane tests a face's bbox against the tile widened by one pixel
//   (which covers the 1e-5 barycentric slack of the inside test, so the cull
//   is exact against the uncut plain version), and __ballot_sync plus a
//   popc prefix compacts each 32 faces' hits into a list in shared memory,
//   to which each hit lane copies its face's coefficients: only faces that
//   touch the tile are loaded, and 32 faces with no hit cost one ballot;
// * every lane then walks the list.
// Planes are evaluated as (a*X + b*Y) + c with __fmul_rn/__fadd_rn (and
// -fmad=false): fused multiply-adds would move the coverage of pixels on
// shared edges away from the plain PyTorch version, and coverage is held
// bit-identical to it. The max is exact in any order, so neither the cull
// nor the compaction can change a bit.
//
// Batch axis (raster_batched_launch: B problems of F faces over H x W each,
// what the JAX package's vmap of _render_pallas computes in one launch):
// problem b is blockIdx.z, and its coef, bbox and out rows are reached by
// offsetting the pointers before anything else, so each problem runs the
// arithmetic of an unbatched launch on its rows (F * 48 and F * 16 bytes
// keep every problem's rows 16-byte aligned).
#include <cuda_runtime.h>
#include <stdint.h>

#define RS_T 8       // tile side in pixels
#define RS_FPL 2     // faces each lane culls per step
#define RS_STEP (32 * RS_FPL)
#define RS_STAGES 4  // steps of bboxes in flight
#define RS_EDGE_EPS 1e-5f

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit_async() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_async() {  // the oldest step has landed
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RS_STAGES - 1) : "memory");
}

__device__ __forceinline__ float plane(float a, float b_y, float c, float X) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, X), b_y), c);
}

__global__ void __launch_bounds__(32)
raster_kernel(const float* __restrict__ coef, const float* __restrict__ bbox, int F,
              int H, int W, float* __restrict__ out) {
    __shared__ __align__(16) float4 sbox[RS_STAGES][RS_FPL][32];
    __shared__ __align__(16) float4 hits[32][3];
    {  // this block's problem of the batch
        const size_t b = blockIdx.z;
        coef += b * F * 12;
        bbox += b * F * 4;
        out += b * H * W;
    }
    const int lane = threadIdx.x;
    const int x0 = blockIdx.x * RS_T, y0 = blockIdx.y * RS_T;
    const int px = x0 + 2 * (lane % (RS_T / 2)), py = y0 + lane / (RS_T / 2);
    const float Xa = (float)px, Xb = (float)(px + 1), Y = (float)py;
    // tile bounds widened by one pixel (see the note above)
    const float tx_lo = (float)(x0 - 1), tx_hi = (float)(x0 + RS_T);
    const float ty_lo = (float)(y0 - 1), ty_hi = (float)(y0 + RS_T);
    const unsigned below = (1u << lane) - 1u;
    const float4* box4 = reinterpret_cast<const float4*>(bbox);
    const float4* coef4 = reinterpret_cast<const float4*>(coef);
    float iza = -1.0f, izb = -1.0f;

    const int steps = (F + RS_STEP - 1) / RS_STEP;
    // one commit per step, empty past the end, keeps the group count fixed
#pragma unroll
    for (int s = 0; s < RS_STAGES - 1; ++s) {
#pragma unroll
        for (int j = 0; j < RS_FPL; ++j) {
            const int f = s * RS_STEP + 32 * j + lane;
            if (f < F) copy16_async(&sbox[s][j][lane], box4 + f);
        }
        commit_async();
    }
    for (int st = 0; st < steps; ++st) {
        const int nxt = st + RS_STAGES - 1;
#pragma unroll
        for (int j = 0; j < RS_FPL; ++j) {
            const int f = nxt * RS_STEP + 32 * j + lane;
            if (f < F) copy16_async(&sbox[nxt % RS_STAGES][j][lane], box4 + f);
        }
        commit_async();
        wait_async();
#pragma unroll
        for (int j = 0; j < RS_FPL; ++j) {
            const int f = st * RS_STEP + 32 * j + lane;
            const float4 b = sbox[st % RS_STAGES][j][lane];
            const bool hit =
                f < F && b.x <= tx_hi && b.y >= tx_lo && b.z <= ty_hi && b.w >= ty_lo;
            const unsigned mask = __ballot_sync(0xffffffffu, hit);
            if (mask == 0u) continue;  // uniform across the warp
            if (hit) {
                const int slot = __popc(mask & below);
                hits[slot][0] = coef4[3 * f];
                hits[slot][1] = coef4[3 * f + 1];
                hits[slot][2] = coef4[3 * f + 2];
            }
            __syncwarp();
            const int n = __popc(mask);
            for (int k = 0; k < n; ++k) {
                // (a0 b0 c0 a1) (b1 c1 a2 b2) (c2 az bz cz)
                const float4 u = hits[k][0], v = hits[k][1], w = hits[k][2];
                const float y0b = __fmul_rn(u.y, Y), y1b = __fmul_rn(v.x, Y);
                const float y2b = __fmul_rn(v.w, Y), yzb = __fmul_rn(w.z, Y);
                const bool ina = plane(u.x, y0b, u.z, Xa) >= -RS_EDGE_EPS &&
                                 plane(u.w, y1b, v.y, Xa) >= -RS_EDGE_EPS &&
                                 plane(v.z, y2b, w.x, Xa) >= -RS_EDGE_EPS;
                const bool inb = plane(u.x, y0b, u.z, Xb) >= -RS_EDGE_EPS &&
                                 plane(u.w, y1b, v.y, Xb) >= -RS_EDGE_EPS &&
                                 plane(v.z, y2b, w.x, Xb) >= -RS_EDGE_EPS;
                if (ina) iza = fmaxf(iza, plane(w.y, yzb, w.w, Xa));
                if (inb) izb = fmaxf(izb, plane(w.y, yzb, w.w, Xb));
            }
            __syncwarp();  // the next hits overwrite the list
        }
    }
    if (py < H) {
        if (px < W) out[py * W + px] = iza;
        if (px + 1 < W) out[py * W + px + 1] = izb;
    }
}

extern "C" int raster_batched_launch(const void* coef, const void* bbox, int F, int B,
                                     int H, int W, void* out, void* stream) {
    if (H > 0 && W > 0 && B > 0) {
        const dim3 grid((W + RS_T - 1) / RS_T, (H + RS_T - 1) / RS_T, B);
        raster_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
            (const float*)coef, (const float*)bbox, F, H, W, (float*)out);
    }
    return (int)cudaGetLastError();
}

extern "C" int raster_launch(const void* coef, const void* bbox, int F, int H, int W,
                             void* out, void* stream) {
    return raster_batched_launch(coef, bbox, F, 1, H, W, out, stream);
}
