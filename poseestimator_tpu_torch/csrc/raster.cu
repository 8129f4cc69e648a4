// K2: triangle z-buffer (max of 1/z over covering faces) for Hopper.
//
// Replaces the Pallas TPU kernel _raster_kernel of
// poseestimator_tpu/render/raster.py (launched by _render_pallas). Inputs are
// the per-face setup of face_coeffs: coef (F, 12) float32 — the planes
// (a, b, c) of the three normalized barycentrics, then the 1/z plane — and
// bbox (F, 4) = (xmin, xmax, ymin, ymax) in window pixels, with the window
// origin already folded in. Output izmax (H, W) float32: -1 where no face
// covers the pixel.
//
// What bounds it on an H100: with the bbox cull, the work is the pixels that
// each face's bbox overlaps times ~20 float32 operations (four planes at two
// mul + two add, three compares, a max); bytes are 64 per face plus 4 per
// pixel. At the tracking window (128 x 128 px, 256 padded faces of which 12
// are real) both bounds are far below a microsecond, so a launch is bound by
// its fixed cost; at a 4096-face mesh over a 320 x 240 frame the operations
// dominate.
//
// Design: one block per 32 x 8 pixel tile, one thread per pixel (a warp is one
// 128-byte row of the tile, so the store is coalesced). Faces are staged
// through shared memory in chunks of CHUNK: the block copies the chunk's
// coefficients with coalesced loads, and each thread tests one face's bbox
// against the tile (widened by one pixel, which covers the 1e-5 barycentric
// slack of the inside test); a chunk no face of which touches the tile is
// skipped whole, and inside a chunk a face that misses the tile is skipped
// by a branch that is uniform across the block. Each thread keeps its
// pixel's max 1/z in a register. Planes are evaluated as (a*X + b*Y) + c with
// __fmul_rn/__fadd_rn (and -fmad=false): fused multiply-adds would move the
// coverage of pixels on shared edges away from the plain PyTorch version,
// and coverage is held bit-identical to it.
#include <cuda_runtime.h>
#include <stdint.h>

#define RS_TW 32
#define RS_TH 8
#define RS_THREADS (RS_TW * RS_TH)
#define RS_CHUNK RS_THREADS
#define RS_EDGE_EPS 1e-5f

__device__ __forceinline__ float plane(const float* c, float X, float Y) {
    return __fadd_rn(__fadd_rn(__fmul_rn(c[0], X), __fmul_rn(c[1], Y)), c[2]);
}

__global__ void __launch_bounds__(RS_THREADS)
raster_kernel(const float* __restrict__ coef, const float* __restrict__ bbox, int F,
              int H, int W, float* __restrict__ out) {
    __shared__ float sc[RS_CHUNK * 12];
    __shared__ uint8_t hit[RS_CHUNK];
    const int tid = threadIdx.y * RS_TW + threadIdx.x;
    const int x0 = blockIdx.x * RS_TW;
    const int y0 = blockIdx.y * RS_TH;
    const float X = (float)(x0 + threadIdx.x);
    const float Y = (float)(y0 + threadIdx.y);
    // tile bounds widened by one pixel (see the note above)
    const float tx_lo = (float)(x0 - 1), tx_hi = (float)(x0 + RS_TW);
    const float ty_lo = (float)(y0 - 1), ty_hi = (float)(y0 + RS_TH);
    float izmax = -1.0f;

    for (int base = 0; base < F; base += RS_CHUNK) {
        const int n = min(RS_CHUNK, F - base);
        for (int k = tid; k < n * 12; k += RS_THREADS) sc[k] = coef[base * 12 + k];
        int h = 0;
        if (tid < n) {
            const float* b = bbox + 4 * (base + tid);
            h = (b[0] <= tx_hi) && (b[1] >= tx_lo) && (b[2] <= ty_hi) && (b[3] >= ty_lo);
        }
        hit[tid] = (uint8_t)h;
        if (!__syncthreads_or(h)) continue;  // no face of this chunk touches the tile
        for (int f = 0; f < n; ++f) {
            if (!hit[f]) continue;  // uniform across the block
            const float* c = sc + 12 * f;
            const float w0 = plane(c, X, Y);
            const float w1 = plane(c + 3, X, Y);
            const float w2 = plane(c + 6, X, Y);
            const float iz = plane(c + 9, X, Y);
            const bool inside =
                (w0 >= -RS_EDGE_EPS) && (w1 >= -RS_EDGE_EPS) && (w2 >= -RS_EDGE_EPS);
            if (inside) izmax = fmaxf(izmax, iz);
        }
        __syncthreads();  // the next chunk overwrites sc and hit
    }
    const int px = x0 + threadIdx.x, py = y0 + threadIdx.y;
    if (px < W && py < H) out[py * W + px] = izmax;
}

extern "C" int raster_launch(const void* coef, const void* bbox, int F, int H, int W,
                             void* out, void* stream) {
    if (H > 0 && W > 0) {
        const dim3 block(RS_TW, RS_TH);
        const dim3 grid((W + RS_TW - 1) / RS_TW, (H + RS_TH - 1) / RS_TH);
        raster_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const float*)coef, (const float*)bbox, F, H, W, (float*)out);
    }
    return (int)cudaGetLastError();
}
