// Ensemble traversal kernels for Hopper (sm_90a): the serving path's
// descent of every query row through every tree of a flat node table,
// with the leaf-value reduction over the trees in member order.
//
//   for each row r, for t = 0 .. T-1 (member order):
//     node = root[t]; up to n_steps times: stop at a leaf (feature < 0),
//       else node = X[r, feature[node]] <= threshold[node] ? left : right
//     v = values[node, :]
//     out[r, :] starts at init[:] (a boosting baseline), else 0
//     sum:    out[r, c] += v[c]
//     norm:   out[r, c] += v[c] / max(sum_k v[k], 1)     (float64 only)
//     percls: out[r, t mod n_out] += v[0]
//
// Replaces the Pallas kernel mpitree_tpu/serving/pallas_serve.py:49
// (_traverse_kernel). That kernel turns each node lookup into a one-hot
// matmul over a stacked (T, 8, Mp) per-tree table because Mosaic has no
// vector gather; here every lookup is a direct load from the flat
// depth-packed node table.
//
// Two instantiations of one kernel body:
//   traverse    (K4): float64 leaf values, float64 accumulator;
//   traverse_q  (K5): int8 leaf values, int32 accumulator (the integer
//                     lattice sum; the caller applies the affine
//                     dequantization once).
// Both descend the same node record, one 16-byte int4 per node: (feature,
// threshold as float32 bits, left, right), packed once when a model is
// compiled (serving/serve_kernel.pack_nodes). K5's int16 feature ids and
// bfloat16 thresholds are widened exactly (a bfloat16 is the top half of a
// float32), so the compare is the plain version's `x <= thr` in float32.
//
// What bounds it: each descent step is a dependent L2 load (the record of
// the next node), so a single chain waits on L2 latency, and a one-row
// request has only T chains. The design therefore spreads the work as wide
// as the data allows:
//   - a block takes R rows (staged in shared memory with coalesced loads)
//     and walks the trees in chunks of Tc; in each chunk one thread
//     descends one (row, tree) pair (one 16-byte load per step) and writes
//     the leaf id to shared memory: T independent chains for one row, R*T
//     per block;
//   - then one thread per (row, output column) adds the chunk's leaf terms
//     in member order to its accumulator, which carries over the chunks in
//     chunk order (in shared memory), and the last chunk writes `out`.
// One block owns all trees of its rows, so every output element is reduced
// by one thread, tree by tree, in member order: never split across threads
// or combined by atomics. A non-null `init` (n_out values) is where each
// row's accumulator starts: a boosted model's baseline margins, added
// first as the estimator's host loop adds them. All output columns are written by one launch.
// The host-side planner (serve_kernel.plan) picks R and Tc per shape.
//
// Exactness: float64 adds and divides use __dadd_rn/__ddiv_rn, which nvcc
// never contracts into an FMA: each result is the correctly rounded IEEE
// operation the plain version performs, in the same order, so K4 equals it
// bit for bit. norm's row sum is taken in channel order, once per (row,
// tree); it is exact for the integer-valued count channels norm serves.
// K5's int32 sum is exact in any order.
//
// Shared memory (dynamic; the planner's byte count must match
// smem_bytes): acc [R*n_out] | norm only: denom [R*Tc] double | leaf
// [R*Tc] int32 | stage_x only: X rows [R*F] float32, each rounded up to 16
// bytes. The launch functions return cudaGetLastError() after the launch
// and allocate nothing; the caller passes the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Agg { kSum = 0, kNorm = 1, kPercls = 2 };
constexpr size_t kStaticSmem = 48 * 1024;  // above it, opt in per kernel

__host__ __device__ __forceinline__ size_t align16(size_t b)
{
    return (b + 15) & ~size_t(15);
}

// Keep in step with serve_kernel._smem_bytes.
__host__ __device__ __forceinline__ size_t smem_bytes(
    int rows, int chunk, int n_out, int n_feat, int acc_bytes, int agg,
    int stage_x)
{
    return align16((size_t)rows * n_out * acc_bytes)
           + (agg == kNorm ? align16((size_t)rows * chunk * 8) : 0)
           + align16((size_t)rows * chunk * 4)
           + (stage_x ? align16((size_t)rows * n_feat * 4) : 0);
}

__device__ __forceinline__ double add_rn(double a, double b)
{
    return __dadd_rn(a, b);
}

__device__ __forceinline__ int32_t add_rn(int32_t a, int32_t b)
{
    return a + b;
}

template <typename Val, typename Acc>
__global__ void traverse_kernel(const float* __restrict__ X,
                                const int4* __restrict__ nodes,
                                const int32_t* __restrict__ root,
                                const Val* __restrict__ values,
                                const Acc* __restrict__ init,
                                Acc* __restrict__ out,
                                int n_rows, int n_feat, int n_trees,
                                int n_steps, int n_chan, int n_out, int agg,
                                int rows_per_block, int trees_per_chunk,
                                int stage_x)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int R = rows_per_block;
    const int Tc = trees_per_chunk;
    Acc* acc = reinterpret_cast<Acc*>(smem);
    size_t off = align16((size_t)R * n_out * sizeof(Acc));
    double* denom = reinterpret_cast<double*>(smem + off);
    if (agg == kNorm) off += align16((size_t)R * Tc * 8);
    int32_t* leaf = reinterpret_cast<int32_t*>(smem + off);
    off += align16((size_t)R * Tc * 4);
    float* xs = reinterpret_cast<float*>(smem + off);

    const int64_t row0 = (int64_t)blockIdx.x * R;
    const int64_t rows_left = (int64_t)n_rows - row0;
    const int rows = rows_left < R ? (int)rows_left : R;
    if (stage_x) {
        const float* src = X + row0 * n_feat;
        for (int i = threadIdx.x; i < rows * n_feat; i += blockDim.x)
            xs[i] = __ldg(src + i);
        __syncthreads();
    }
    // This thread's descent pair in every chunk: row r, chunk tree tl.
    const int r = threadIdx.x % R;
    const int tl = threadIdx.x / R;
    const float* x = stage_x ? xs + r * n_feat : X + (row0 + r) * n_feat;

    for (int t0 = 0; t0 < n_trees; t0 += Tc) {
        const int tc = min(Tc, n_trees - t0);
        if (tl < tc && r < rows) {
            int node = __ldg(root + t0 + tl);
            for (int s = 0; s < n_steps; ++s) {
                const int4 rec = __ldg(nodes + node);
                if (rec.x < 0) break;  // a leaf holds
                node = x[rec.x] <= __int_as_float(rec.y) ? rec.z : rec.w;
            }
            leaf[threadIdx.x] = node;
            if constexpr (sizeof(Acc) == sizeof(double)) {
                if (agg == kNorm) {
                    const Val* v = values + (int64_t)node * n_chan;
                    double rowsum = 0.0;
                    for (int k = 0; k < n_chan; ++k)
                        rowsum = __dadd_rn(rowsum, (double)__ldg(v + k));
                    denom[threadIdx.x] = fmax(rowsum, 1.0);
                }
            }
        }
        __syncthreads();

        // The ordered reduction: thread p owns out[row0 + p / n_out,
        // p % n_out] in every chunk, so its accumulator carries over.
        const bool last = t0 + tc >= n_trees;
        for (int p = threadIdx.x; p < rows * n_out; p += blockDim.x) {
            const int rr = p / n_out;
            const int c = p % n_out;
            Acc a = t0 != 0 ? acc[p] : init != nullptr ? init[c] : Acc(0);
            if (agg == kPercls) {
                // chunk trees t0 + j with (t0 + j) mod n_out == c
                for (int j = ((c - t0) % n_out + n_out) % n_out; j < tc;
                     j += n_out)
                    a = add_rn(a, (Acc)__ldg(
                        values + (int64_t)leaf[j * R + rr] * n_chan));
            } else if (agg == kNorm) {
                if constexpr (sizeof(Acc) == sizeof(double)) {
#pragma unroll 4
                    for (int j = 0; j < tc; ++j)
                        a = __dadd_rn(a, __ddiv_rn(
                            (double)__ldg(values + (int64_t)leaf[j * R + rr]
                                          * n_chan + c),
                            denom[j * R + rr]));
                }
            } else {
#pragma unroll 4
                for (int j = 0; j < tc; ++j)
                    a = add_rn(a, (Acc)__ldg(
                        values + (int64_t)leaf[j * R + rr] * n_chan + c));
            }
            if (last)
                out[row0 * n_out + p] = a;
            else
                acc[p] = a;
        }
        if (!last) __syncthreads();  // the next chunk rewrites leaf/denom
    }
}

template <typename Val, typename Acc>
int launch(const void* X, const void* nodes, const void* root,
           const void* values, const void* init, void* out, int n_rows,
           int n_feat,
           int n_trees, int n_steps, int n_chan, int n_out, int agg,
           int rows_per_block, int trees_per_chunk, int stage_x,
           int threads, int smem, void* stream)
{
    if (rows_per_block < 1 || trees_per_chunk < 1
        || threads < rows_per_block
                         * (trees_per_chunk < n_trees ? trees_per_chunk
                                                      : n_trees)
        || (size_t)smem < smem_bytes(rows_per_block, trees_per_chunk, n_out,
                                     n_feat, (int)sizeof(Acc), agg, stage_x))
        return (int)cudaErrorInvalidValue;
    if ((size_t)smem > kStaticSmem) {
        const cudaError_t e = cudaFuncSetAttribute(
            traverse_kernel<Val, Acc>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (int)(((int64_t)n_rows + rows_per_block - 1)
                             / rows_per_block);
    traverse_kernel<Val, Acc><<<blocks, threads, smem,
                                (cudaStream_t)stream>>>(
        (const float*)X, (const int4*)nodes, (const int32_t*)root,
        (const Val*)values, (const Acc*)init, (Acc*)out, n_rows, n_feat,
        n_trees, n_steps, n_chan, n_out, agg, rows_per_block,
        trees_per_chunk, stage_x);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mpt_traverse(const void* X, const void* nodes, const void* root,
                 const void* values, const void* init, void* out,
                 int n_rows, int n_feat, int n_trees, int n_steps,
                 int n_chan, int n_out, int agg, int rows_per_block,
                 int trees_per_chunk, int stage_x, int threads, int smem,
                 void* stream)
{
    return launch<double, double>(
        X, nodes, root, values, init, out, n_rows, n_feat, n_trees,
        n_steps, n_chan, n_out, agg, rows_per_block, trees_per_chunk,
        stage_x, threads, smem, stream);
}

int mpt_traverse_q(const void* X, const void* nodes, const void* root,
                   const void* values, const void* init, void* out,
                   int n_rows, int n_feat, int n_trees, int n_steps,
                   int n_chan, int n_out, int agg, int rows_per_block,
                   int trees_per_chunk, int stage_x, int threads, int smem,
                   void* stream)
{
    return launch<int8_t, int32_t>(
        X, nodes, root, values, init, out, n_rows, n_feat, n_trees,
        n_steps, n_chan, n_out, agg, rows_per_block, trees_per_chunk,
        stage_x, threads, smem, stream);
}

const char* mpt_traverse_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
