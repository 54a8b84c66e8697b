// Payload histogram kernels for Hopper (sm_90a): the (slot, feature,
// channel, bin) histogram every tree level needs.
//
//   out[s, f, c, b] += payload[r, c]   for every row r with
//                      slot[r] == s in [0, S) and xb[r, f] == b in [0, B)
//
// Layouts (row-major, all contiguous): xb (N, F) int32, payload (N, C)
// float32, slot (N,) int32, out (S, F, C, B) float32, zeroed by the
// caller. Rows whose slot lies outside [0, S) add nothing and read nothing
// but their slot; bin ids outside [0, B) add nothing (the plain version
// masks them the same way). Channels whose payload is zero are skipped: a
// class payload w*onehot(y) issues one add per (row, feature), not C.
//
// Both kernels give one thread one (row, feature) element, so neighbouring
// threads read neighbouring bin ids of a row (coalesced) and add into
// different features' histograms (few atomic conflicts even when every row
// of a level sits in one slot, as at the root).
//
// hist_small_kernel — privatized in shared memory. A block owns a tile of
//   all S slots x `feat_per_block` features (all C channels, all B bins),
//   zeroes it, adds its share of rows with shared-memory float atomics,
//   then flushes the nonzero cells with global atomics. It takes as many
//   features per block as the 227 KB allow (S=1, C=7, B=256: 27 features
//   in two balanced groups, 190 KB). The wrapper sends it only the widths
//   where it measured faster than hist_wide_kernel (ops/hist_kernel.py).
//
// hist_wide_kernel — adds straight into the (S, F, C, B) output in device
//   memory with global float atomics, for every other width. For frontiers
//   of hundreds to thousands of slots the histogram (0.8 GB at 2048 slots x
//   54 features x 7 classes x 256 bins) cannot be privatized.
//
// Exactness: for integer-valued payloads whose sums stay below 2^24 (class
// counts, integer sample weights) every partial sum is exact in float32,
// so the result does not depend on the order of the atomics and is
// bit-identical to the plain version. Output offsets are 64-bit; element
// ids are 32-bit, N * F < 2^31 (checked by the wrapper).
//
// The launch functions return cudaGetLastError() after the launch and
// allocate nothing; the caller passes the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmallThreads = 1024;

__global__ void __launch_bounds__(kSmallThreads)
hist_small_kernel(const int32_t* __restrict__ xb,
                  const float* __restrict__ payload,
                  const int32_t* __restrict__ slot,
                  float* __restrict__ out,
                  int n_rows, int n_feat, int n_chan, int n_bins,
                  int n_slots, int feat_per_block, int rows_per_block)
{
    // [S][fc][C][B + 1]: each (slot, feature, channel) row is padded by
    // one float, so rows start in different banks. Unpadded, a row is 256
    // floats (a multiple of the 32 banks) and a warp adding into the
    // two-bin one-hot columns of many features piles onto banks 0 and 1.
    extern __shared__ float tile[];
    const int f0 = blockIdx.x * feat_per_block;
    const int fc = min(feat_per_block, n_feat - f0);
    const int bp = n_bins + 1;
    const int cells = n_slots * fc * n_chan * bp;

    for (int i = threadIdx.x; i < cells; i += blockDim.x) tile[i] = 0.0f;
    __syncthreads();

    const int r0 = blockIdx.y * rows_per_block;
    const int r1 = min(n_rows, r0 + rows_per_block);
    const unsigned n_elem = (unsigned)max(r1 - r0, 0) * (unsigned)fc;
    for (unsigned e = threadIdx.x; e < n_elem; e += blockDim.x) {
        const unsigned rl = e / (unsigned)fc;
        const int fl = (int)(e - rl * (unsigned)fc);
        const int r = r0 + (int)rl;
        const int s = slot[r];
        if (s < 0 || s >= n_slots) continue;
        const int b = xb[(int64_t)r * n_feat + f0 + fl];
        if ((unsigned)b >= (unsigned)n_bins) continue;
        const float* p = payload + (int64_t)r * n_chan;
        float* t = tile + (s * fc + fl) * n_chan * bp + b;
        for (int c = 0; c < n_chan; ++c) {
            const float v = p[c];
            if (v != 0.0f) atomicAdd(t + c * bp, v);
        }
    }
    __syncthreads();

    // Flush; the pad column is never written, so it is zero and skipped.
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        const float v = tile[i];
        if (v == 0.0f) continue;
        const int row = i / bp;
        const int b = i - row * bp;
        const int q = row / n_chan;
        const int c = row - q * n_chan;
        const int s = q / fc;
        const int fl = q - s * fc;
        atomicAdd(out + (((int64_t)s * n_feat + f0 + fl) * n_chan + c)
                  * n_bins + b, v);
    }
}

__global__ void
hist_wide_kernel(const int32_t* __restrict__ xb,
                 const float* __restrict__ payload,
                 const int32_t* __restrict__ slot,
                 float* __restrict__ out,
                 int n_rows, int n_feat, int n_chan, int n_bins, int n_slots)
{
    const unsigned total = (unsigned)n_rows * (unsigned)n_feat;
    const int64_t cb = (int64_t)n_chan * n_bins;
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += gridDim.x * blockDim.x) {
        const unsigned r = i / (unsigned)n_feat;
        const int s = slot[r];
        if (s < 0 || s >= n_slots) continue;
        const int b = xb[i];
        if ((unsigned)b >= (unsigned)n_bins) continue;
        const int f = (int)(i - r * (unsigned)n_feat);
        const float* p = payload + (int64_t)r * n_chan;
        float* o = out + ((int64_t)s * n_feat + f) * cb + b;
        for (int c = 0; c < n_chan; ++c) {
            const float v = p[c];
            if (v != 0.0f) atomicAdd(o + (int64_t)c * n_bins, v);
        }
    }
}

}  // namespace

extern "C" {

int mpt_hist_small(const void* xb, const void* payload, const void* slot,
                   void* out, int n_rows, int n_feat, int n_chan,
                   int n_bins, int n_slots, int feat_per_block,
                   int n_fgroups, int n_rblocks, int rows_per_block,
                   int smem_bytes, void* stream)
{
    if (smem_bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            hist_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem_bytes);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(n_fgroups, n_rblocks);
    hist_small_kernel<<<grid, kSmallThreads, smem_bytes,
                        (cudaStream_t)stream>>>(
        (const int32_t*)xb, (const float*)payload, (const int32_t*)slot,
        (float*)out, n_rows, n_feat, n_chan, n_bins, n_slots,
        feat_per_block, rows_per_block);
    return (int)cudaGetLastError();
}

int mpt_hist_wide(const void* xb, const void* payload, const void* slot,
                  void* out, int n_rows, int n_feat, int n_chan, int n_bins,
                  int n_slots, int blocks, int threads, void* stream)
{
    hist_wide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)xb, (const float*)payload, (const int32_t*)slot,
        (float*)out, n_rows, n_feat, n_chan, n_bins, n_slots);
    return (int)cudaGetLastError();
}

const char* mpt_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
