// What the two histogram bodies share: csrc/histogram.cu (the integer
// routes) and csrc/fixed_hist.cu (the fixed-point routes) each include it
// into their own library (_build.py hashes it with every source).
//
// A block takes a feature group's tile: the group's (tile offset, bin
// count) pairs come first in shared memory, and each thread reads one
// 16-feature lane of a row's bins at a time. The sorted route's blocks
// take pieces of the slot-ordered rows; a slot split into pieces is zeroed
// first, then added into.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneFeat = 16;  // features of a row one thread takes

// Size of a group's (tile offset, bin count) table, 16-byte rounded.
__host__ __device__ constexpr int feat_bytes(int n)
{
    return (n * 8 + 15) & ~15;
}

// A thread's 16 bin ids of one row, in registers.
template <typename BinT> struct RowBins;

template <> struct RowBins<uint8_t> {
    uint4 w;
    __device__ __forceinline__ void load(const uint8_t* row, int f_lo, int) {
        w = __ldg(reinterpret_cast<const uint4*>(row + f_lo));
    }
    __device__ __forceinline__ unsigned get(int j) const {
        const unsigned v = j < 4 ? w.x : j < 8 ? w.y : j < 12 ? w.z : w.w;
        return (v >> ((j & 3) * 8)) & 0xffu;
    }
};

template <> struct RowBins<int32_t> {
    int32_t v[kLaneFeat];
    __device__ __forceinline__ void load(const int32_t* row, int f_lo,
                                         int n_feat) {
#pragma unroll
        for (int j = 0; j < kLaneFeat; ++j)
            v[j] = f_lo + j < n_feat ? __ldg(row + f_lo + j) : -1;
    }
    __device__ __forceinline__ unsigned get(int j) const {
        return (unsigned)v[j];
    }
};

// The sorted route's rows for block v: positions [a, b) of `order`. Block
// v < S takes the first piece_rows rows of slot v and owns the slot when
// it has no more; a further piece of slot s starts at q = seg[s] + k *
// piece_rows (k >= 1, q < seg[s + 1]) and is taken by block S + (q -
// seg[0]) / piece_rows: at most one such q falls into any stretch of
// piece_rows positions, because a slot has one only when it is longer
// than that (ops/hist_kernel.block_pieces). False: block v has no rows.
__device__ __forceinline__ bool sorted_piece(const int32_t* seg, int n_slots,
                                             int piece_rows, int v, int& own,
                                             int& a, int& b, bool& owned)
{
    if (v < n_slots) {
        own = v;
        a = seg[v];
        const int end = seg[v + 1];
        owned = end - a <= piece_rows;
        b = owned ? end : a + piece_rows;
        return true;
    }
    const int pos = seg[0] + (v - n_slots) * piece_rows;
    if (pos >= seg[n_slots]) return false;
    int lo = 0, hi = n_slots;  // last s with seg[s] <= pos
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (seg[mid] <= pos) lo = mid; else hi = mid;
    }
    const int k = (pos - seg[lo] + piece_rows - 1) / piece_rows;
    a = seg[lo] + k * piece_rows;
    if (k == 0 || a >= seg[lo + 1]) return false;
    own = lo;
    b = min(a + piece_rows, seg[lo + 1]);
    return true;
}

// Zeroes out[s] (slot_bytes bytes a slot, a multiple of 4) for every slot
// that the sorted route splits into pieces.
__global__ void
hist_zero_split_kernel(const int32_t* __restrict__ seg,
                       unsigned char* __restrict__ out, int piece_rows,
                       int64_t slot_bytes)
{
    const int s = blockIdx.x;
    if (seg[s + 1] - seg[s] <= piece_rows) return;
    unsigned char* o = out + s * slot_bytes;
    const int64_t step = (int64_t)gridDim.y * blockDim.x;
    const int64_t first = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
    if ((slot_bytes & 15) == 0) {
        uint4* o4 = reinterpret_cast<uint4*>(o);
        for (int64_t i = first; i < (slot_bytes >> 4); i += step)
            o4[i] = make_uint4(0u, 0u, 0u, 0u);
    } else {  // a slot's cells not a multiple of 16 bytes
        unsigned* o1 = reinterpret_cast<unsigned*>(o);
        for (int64_t i = first; i < (slot_bytes >> 2); i += step) o1[i] = 0u;
    }
}

// Launches hist_zero_split_kernel over the S slots' outputs.
inline cudaError_t zero_split_slots(const void* seg, void* out, int n_slots,
                                    int piece_rows, int64_t slot_bytes,
                                    cudaStream_t stream)
{
    hist_zero_split_kernel<<<dim3(n_slots, 8), 256, 0, stream>>>(
        (const int32_t*)seg, (unsigned char*)out, piece_rows, slot_bytes);
    return cudaGetLastError();
}

}  // namespace

extern "C" const char* mpt_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
