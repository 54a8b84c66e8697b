// Ensemble traversal kernels for Hopper (sm_90a): the serving path's
// descent of every query row through every tree of a flat node table,
// with the leaf-value reduction over the trees in member order.
//
//   for each row r, for t = 0 .. T-1 (member order):
//     node = root[t]; up to n_steps times: stop at a leaf (feature < 0),
//       else node = X[r, feature[node]] <= threshold[node] ? left : right
//     v = values[node, :]
//     sum:    out[r, c] += v[c]
//     norm:   out[r, c] += v[c] / max(sum_k v[k], 1)     (float64 only)
//     percls: out[r, t mod n_out] += v[0]
//
// Replaces the Pallas kernel mpitree_tpu/serving/pallas_serve.py:49
// (_traverse_kernel). That kernel turns each node lookup into a one-hot
// matmul over a stacked (T, 8, Mp) per-tree table because Mosaic has no
// vector gather; here every lookup is a direct load from the flat
// depth-packed NodeTable columns the plain version reads too, so a model
// holds one device copy of its table.
//
// Two instantiations of one kernel body:
//   traverse    (K4): int32 feature, float32 threshold, float64 values,
//                     float64 accumulator;
//   traverse_q  (K5): int16 feature, bfloat16 threshold (raw bits, upcast
//                     exactly to float32 for the compare), int8 values,
//                     int32 accumulator (the integer lattice sum; the
//                     caller applies the affine dequantization once).
//
// Design: one thread per row, a loop over the trees, every table load
// through the read-only path (__ldg). At serving sizes the flat table is a
// few MB and stays in the 50 MB L2. What bounds it: each step is a chain
// of dependent loads (feature, then X and threshold, then a child id), so
// a thread waits on L2 latency; enough rows in flight hide it, a
// one-row request does not (PERF.md).
//
// Exactness: the accumulator lives in registers in blocks of kBlockOut
// output columns (the wrapper launches once per block; c0 is the block's
// first column), starts at zero and is written to `out` once at the end,
// so `out` need not be initialised. Float64 adds and divides use
// __dadd_rn/__ddiv_rn, which nvcc never contracts into an FMA: each result
// is the correctly rounded IEEE operation the plain version performs, in
// the same order, so the kernel equals it bit for bit. norm's row sum is taken in channel
// order; it is exact for the integer-valued count channels norm serves.
//
// The launch functions return cudaGetLastError() after the launch and
// allocate nothing; the caller passes the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockOut = 8;  // BLOCK_OUT in serving/serve_kernel.py
enum Agg { kSum = 0, kNorm = 1, kPercls = 2 };

__device__ __forceinline__ float load_threshold(const float* t, int i)
{
    return __ldg(t + i);
}

// bfloat16 is the top half of a float32: the upcast is exact.
__device__ __forceinline__ float load_threshold(const uint16_t* t, int i)
{
    return __uint_as_float((uint32_t)__ldg(t + i) << 16);
}

__device__ __forceinline__ double add_rn(double a, double b)
{
    return __dadd_rn(a, b);
}

__device__ __forceinline__ int32_t add_rn(int32_t a, int32_t b)
{
    return a + b;
}

template <typename Feat, typename Thr, typename Val, typename Acc>
__global__ void traverse_kernel(const float* __restrict__ X,
                                const Feat* __restrict__ feature,
                                const Thr* __restrict__ threshold,
                                const int32_t* __restrict__ left,
                                const int32_t* __restrict__ right,
                                const int32_t* __restrict__ root,
                                const Val* __restrict__ values,
                                Acc* __restrict__ out,
                                int n_rows, int n_feat, int n_trees,
                                int n_steps, int n_chan, int n_out, int c0,
                                int agg)
{
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= n_rows) return;
    const int nb = min(kBlockOut, n_out - c0);
    const float* x = X + (int64_t)row * n_feat;
    Acc* o = out + (int64_t)row * n_out + c0;

    Acc acc[kBlockOut];
#pragma unroll
    for (int j = 0; j < kBlockOut; ++j) acc[j] = Acc(0);

    for (int t = 0; t < n_trees; ++t) {
        int node = __ldg(root + t);
        for (int s = 0; s < n_steps; ++s) {
            const int f = (int)__ldg(feature + node);
            if (f < 0) break;  // a leaf holds
            node = __ldg(x + f) <= load_threshold(threshold, node)
                       ? __ldg(left + node) : __ldg(right + node);
        }
        const Val* v = values + (int64_t)node * n_chan;
        if (agg == kPercls) {
            const Acc a = (Acc)__ldg(v);
            const int col = t % n_out - c0;
#pragma unroll
            for (int j = 0; j < kBlockOut; ++j)
                if (j == col) acc[j] = add_rn(acc[j], a);
        } else if (agg == kNorm) {
            if constexpr (sizeof(Acc) == sizeof(double)) {
                double rowsum = 0.0;
                for (int k = 0; k < n_chan; ++k)
                    rowsum = __dadd_rn(rowsum, (double)__ldg(v + k));
                const double denom = fmax(rowsum, 1.0);
#pragma unroll
                for (int j = 0; j < kBlockOut; ++j)
                    if (j < nb)
                        acc[j] = __dadd_rn(
                            acc[j], __ddiv_rn((double)__ldg(v + c0 + j),
                                              denom));
            }
        } else {
#pragma unroll
            for (int j = 0; j < kBlockOut; ++j)
                if (j < nb) acc[j] = add_rn(acc[j], (Acc)__ldg(v + c0 + j));
        }
    }
#pragma unroll
    for (int j = 0; j < kBlockOut; ++j)
        if (j < nb) o[j] = acc[j];
}

}  // namespace

extern "C" {

int mpt_traverse(const void* X, const void* feature, const void* threshold,
                 const void* left, const void* right, const void* root,
                 const void* values, void* out, int n_rows, int n_feat,
                 int n_trees, int n_steps, int n_chan, int n_out, int c0,
                 int agg, int threads, void* stream)
{
    const int blocks = (n_rows + threads - 1) / threads;
    traverse_kernel<int32_t, float, double, double>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)X, (const int32_t*)feature,
            (const float*)threshold, (const int32_t*)left,
            (const int32_t*)right, (const int32_t*)root,
            (const double*)values, (double*)out, n_rows, n_feat, n_trees,
            n_steps, n_chan, n_out, c0, agg);
    return (int)cudaGetLastError();
}

int mpt_traverse_q(const void* X, const void* feature, const void* threshold,
                   const void* left, const void* right, const void* root,
                   const void* values, void* out, int n_rows, int n_feat,
                   int n_trees, int n_steps, int n_chan, int n_out, int c0,
                   int agg, int threads, void* stream)
{
    const int blocks = (n_rows + threads - 1) / threads;
    traverse_kernel<int16_t, uint16_t, int8_t, int32_t>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)X, (const int16_t*)feature,
            (const uint16_t*)threshold, (const int32_t*)left,
            (const int32_t*)right, (const int32_t*)root,
            (const int8_t*)values, (int32_t*)out, n_rows, n_feat, n_trees,
            n_steps, n_chan, n_out, c0, agg);
    return (int)cudaGetLastError();
}

const char* mpt_traverse_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
