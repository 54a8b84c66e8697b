// The boosted-margin traversal for Hopper (sm_90a): the serving path's
// `percls` reduction of a boosted ensemble, redesigned for its shape
// (hundreds of shallow trees, one value channel, tree t into output column
// t mod K), beside the general body of csrc/traverse.cu.
//
//   for each row r and column c:
//     out[r, c] = init[c] (a boosting baseline), else 0
//     for t = c, c + K, c + 2K, ... (member order):
//       descend tree t from its root: stop at a leaf, else go left when
//         X[r, feature] <= threshold;  out[r, c] += value[leaf]
//
// Replaces, for `percls` launches, the Pallas kernel
// mpitree_tpu/serving/pallas_serve.py:49 (_traverse_kernel, its `percls`
// mode :133-140), as csrc/traverse.cu does for `sum` and `norm`.
//
// What bounded the general body on this shape: each descent step was a
// 16-byte L2 load, and the ordered reduction loaded every leaf value from
// L2 in a dependent chain, one tree after another. This body:
//   - descends an 8-byte record per node, packed once per model
//     (serving/serve_kernel.pack_margin): trees grouped by output column,
//     each tree's nodes in breadth-first order with siblings adjacent, so a
//     record holds (feature | left child << 16, threshold) and the right
//     child is left + 1; a leaf holds (-1, payload), where the payload is
//     the int8 value itself (K5) or the index of its float64 value (K4);
//   - gives every block one output column, so all of an output element's
//     terms are added by one thread, and a column's trees are one
//     contiguous range of the pack, staged in chunks of whole trees that fit
//     the table budget (cp.async, 16 bytes a copy); the descents then read
//     shared memory only;
//   - keeps the blocks resident: block (p, c) stages column c's chunk once
//     and walks row tiles p, p + P, ... through it, so the table crosses L2
//     once per block and not once per row tile. A column of more than one
//     chunk takes the chunks in order, each over all the block's tiles, and
//     carries each row's sum in `out` (the same thread reads back what it
//     wrote);
//   - gathers the leaf value in the descending thread: K4 writes the
//     float64 term to shared memory, and after each pass of trees one thread
//     per row adds the pass's terms in member order with __dadd_rn (never
//     contracted), from `init`, so K4 equals the plain version bit for bit;
//     K5 adds its int32 term with a shared-memory atomic, exact in any
//     order.
// A small batch (few rows a block) does not stage: each record is read by
// a few rows only, and the descent reads the pack in global memory. A chunk
// larger than the budget (one very large tree) is descended in global
// memory too. The host planner (serve_kernel.plan_margin) picks the tiling.
//
// What bounds it now (PERF.md §6, chip_smoke.py phase 23): the descents'
// shared-memory gathers. A warp's lanes take neighbouring rows of one tree
// (G threads a row, G chosen so the block holds 1,024); near the root
// they share a record (a broadcast), on a shallow tree's last levels they
// spread over up to 64 records, several to a bank, and the X reads
// scatter too. More descents in flight per thread, a reduction by warp
// shuffles and a feature-major X layout were each slower on the card.
//
// Shared memory (dynamic; the planner's count must match smem_bytes):
// table [table_bytes] | K4: terms [trees_per_pass * rows] double, K5:
// sums [rows] int32 | stage_x only: X rows [rows * x_stride] float32; each
// region rounded up to 16 bytes. The launch functions return
// cudaGetLastError() after the launch and allocate nothing; the caller
// passes the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t kStaticSmem = 48 * 1024;  // above it, opt in per kernel
constexpr int kLeaf = -1;                  // a leaf record's first word

__host__ __device__ __forceinline__ size_t align16(size_t b)
{
    return (b + 15) & ~size_t(15);
}

// Keep in step with obs/memory.margin_smem_bytes.
__host__ __device__ __forceinline__ size_t smem_bytes(
    int rows, int trees_per_pass, int table_bytes, int x_stride,
    int acc_bytes, int stage_x)
{
    const size_t terms = acc_bytes == 8 ? (size_t)rows * trees_per_pass * 8
                                        : (size_t)rows * 4;
    return align16((size_t)table_bytes) + align16(terms)
           + (stage_x ? align16((size_t)rows * x_stride * 4) : 0);
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
}

// n16 16-byte words from global to shared memory, by the whole block
__device__ __forceinline__ void stage16(void* dst, const void* src, int n16)
{
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
        copy16_async(static_cast<int4*>(dst) + i,
                     static_cast<const int4*>(src) + i);
}

// One descent step from internal node `rec` of the tree at `base`: to
// the left child, or to the right one (left + 1) unless x <= threshold.
__device__ __forceinline__ int2 step(const int2* rp, int base, int2 rec,
                                     const float* x)
{
    const int left = (int)((unsigned)rec.x >> 16);
    return rp[base + left + !(x[rec.x & 0xFFFF] <= __int_as_float(rec.y))];
}

// The leaf record a row reaches in the tree at `base` (n_steps bounds the
// walk; the pack's deepest leaf is within it).
__device__ __forceinline__ int2 descend(const int2* rp, int base,
                                        const float* x, int n_steps)
{
    int2 rec = rp[base];
    for (int s = 0; s < n_steps && rec.x != kLeaf; ++s)
        rec = step(rp, base, rec, x);
    return rec;
}

__device__ __forceinline__ double add(double a, double b)
{
    return __dadd_rn(a, b);  // never contracted into an FMA
}

__device__ __forceinline__ int32_t add(int32_t a, int32_t b)
{
    return a + b;
}

// One block an SM (its shared memory holds a table chunk), so the
// compiler need not squeeze registers for two: at (1024) it spilled K4.
template <typename Val, typename Acc>
__global__ void __launch_bounds__(1024, 1)
margin_kernel(const float* __restrict__ X, const int2* __restrict__ recs,
              const Val* __restrict__ leaf_vals,
              const int32_t* __restrict__ tree_rec,
              const int32_t* __restrict__ tree_val,
              const int32_t* __restrict__ chunk_tree,
              const int32_t* __restrict__ col_chunk,
              const Acc* __restrict__ init, Acc* __restrict__ out,
              int n_rows, int n_feat, int n_out, int n_steps,
              int rows_per_block, int threads_per_row, int row_groups,
              int trees_per_pass, int stage_tables, int table_bytes,
              int stage_x, int x_stride)
{
    // K4: float64 terms added in member order; K5: int32 sums, any order
    constexpr bool kOrdered = sizeof(Acc) == 8;
    extern __shared__ __align__(16) unsigned char smem[];
    const int R = rows_per_block;
    const int Ts = trees_per_pass;
    Acc* terms = reinterpret_cast<Acc*>(smem + table_bytes);
    float* xs = reinterpret_cast<float*>(
        smem + table_bytes
        + align16(kOrdered ? (size_t)R * Ts * sizeof(Acc)
                           : (size_t)R * sizeof(Acc)));

    const int c = blockIdx.x % n_out;
    const int p = blockIdx.x / n_out;
    const int n_tiles = (int)(((int64_t)n_rows + R - 1) / R);
    // G threads a row: row r's are threads r, r + R, ... (a warp's lanes
    // take neighbouring rows of one tree), and thread r < R owns row r
    const int G = threads_per_row;
    const int r = threadIdx.x % R;
    const int g = threadIdx.x / R;
    const int k0 = col_chunk[c];
    const int k1 = col_chunk[c + 1];

    for (int k = k0; k < k1; ++k) {
        const int ta = chunk_tree[k];
        const int tb = chunk_tree[k + 1];
        // the chunk's records and values, from their 16-byte aligned starts
        // (the pack pads both arrays to an even length)
        const int rec0 = tree_rec[ta] & ~1;
        const int rec1 = (tree_rec[tb] + 1) & ~1;
        const size_t rec_bytes = (size_t)(rec1 - rec0) * 8;
        int val0 = 0, val1 = 0;
        if constexpr (kOrdered) {
            val0 = tree_val[ta] & ~1;
            val1 = (tree_val[tb] + 1) & ~1;
        }
        const size_t need = rec_bytes + (size_t)(val1 - val0) * sizeof(Val);
        const bool staged = stage_tables && need <= (size_t)table_bytes;
        const int2* rp = recs;
        const Val* vp = leaf_vals;
        int roff = 0, voff = 0;
        if (staged) {
            __syncthreads();  // every descent of the last chunk is done
            stage16(smem, recs + rec0, (int)(rec_bytes / 16));
            if constexpr (kOrdered)
                stage16(smem + rec_bytes, leaf_vals + val0,
                        (int)((size_t)(val1 - val0) * sizeof(Val) / 16));
            asm volatile("cp.async.wait_all;\n" ::: "memory");
            __syncthreads();
            rp = reinterpret_cast<const int2*>(smem);
            vp = reinterpret_cast<const Val*>(smem + rec_bytes);
            roff = rec0;
            voff = val0;
        }

        for (int i = p; i < n_tiles; i += row_groups) {
            const int64_t row0 = (int64_t)i * R;
            const int64_t rows_left = (int64_t)n_rows - row0;
            const int rows = rows_left < R ? (int)rows_left : R;
            if (stage_x) {
                __syncthreads();  // the last tile's descents are done
                const float* src = X + row0 * n_feat;
                for (int e = threadIdx.x; e < rows * n_feat; e += blockDim.x)
                    xs[(e / n_feat) * x_stride + e % n_feat] = __ldg(src + e);
            }
            // thread r < rows holds out[row0 + r, c] in every chunk
            const bool mine = threadIdx.x < rows;
            Acc a = Acc(0);
            if (mine) {
                a = k != k0 ? out[(row0 + r) * n_out + c]
                    : init != nullptr ? init[c] : Acc(0);
                if constexpr (!kOrdered) terms[r] = a;
            }
            __syncthreads();  // the X rows (and K5's sums) are ready
            const float* x = stage_x ? xs + r * x_stride
                                     : X + (row0 + r) * n_feat;
            const bool live = g < G && r < rows;
            // a pass: thread (r, g) descends every G-th tree and writes its
            // term to shared memory; K4's row owner then adds the pass's
            // terms in member order
            for (int s0 = ta; s0 < tb; s0 += Ts) {
                const int s1 = min(s0 + Ts, tb);
                if (live) {
                    for (int t = s0 + g; t < s1; t += G) {
                        const int base = __ldg(tree_rec + t) - roff;
                        const int2 rec = descend(rp, base, x, n_steps);
                        if constexpr (kOrdered)
                            terms[(t - s0) * R + r] = vp[rec.y - voff];
                        else
                            atomicAdd(&terms[r], (Acc)rec.y);
                    }
                }
                if constexpr (kOrdered) {
                    __syncthreads();
                    if (mine) {
#pragma unroll 8
                        for (int j = 0; j < s1 - s0; ++j)
                            a = add(a, terms[j * R + r]);
                    }
                    __syncthreads();  // the next pass rewrites the terms
                }
            }
            if constexpr (!kOrdered) {
                __syncthreads();
                if (mine) a = terms[r];
            }
            if (mine)
                out[(row0 + r) * n_out + c] = a;
        }
    }
}

template <typename Val, typename Acc>
int launch(const void* X, const void* recs, const void* leaf_vals,
           const void* tree_rec, const void* tree_val,
           const void* chunk_tree, const void* col_chunk, const void* init,
           void* out, int n_rows, int n_feat, int n_out, int n_steps,
           int rows_per_block, int threads_per_row, int row_groups,
           int trees_per_pass, int stage_tables, int table_bytes,
           int stage_x, int x_stride, int threads, int smem, void* stream)
{
    if (rows_per_block < 1 || threads_per_row < 1 || row_groups < 1
        || trees_per_pass < 1
        || threads < rows_per_block * threads_per_row || threads > 1024
        || threads % 32 != 0
        || table_bytes < 0 || table_bytes % 16 != 0 || x_stride < n_feat
        || n_out < 1
        || (size_t)smem < smem_bytes(rows_per_block, trees_per_pass,
                                     table_bytes, x_stride,
                                     (int)sizeof(Acc), stage_x))
        return (int)cudaErrorInvalidValue;
    if ((size_t)smem > kStaticSmem) {
        const cudaError_t e = cudaFuncSetAttribute(
            margin_kernel<Val, Acc>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int64_t blocks = (int64_t)n_out * row_groups;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    margin_kernel<Val, Acc><<<(unsigned)blocks, threads, smem,
                              (cudaStream_t)stream>>>(
        (const float*)X, (const int2*)recs, (const Val*)leaf_vals,
        (const int32_t*)tree_rec, (const int32_t*)tree_val,
        (const int32_t*)chunk_tree, (const int32_t*)col_chunk,
        (const Acc*)init, (Acc*)out, n_rows, n_feat, n_out, n_steps,
        rows_per_block, threads_per_row, row_groups, trees_per_pass,
        stage_tables, table_bytes, stage_x, x_stride);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mpt_margin(const void* X, const void* recs, const void* leaf_vals,
               const void* tree_rec, const void* tree_val,
               const void* chunk_tree, const void* col_chunk,
               const void* init, void* out, int n_rows, int n_feat,
               int n_out, int n_steps, int rows_per_block,
               int threads_per_row, int row_groups, int trees_per_pass,
               int stage_tables, int table_bytes, int stage_x, int x_stride,
               int threads, int smem, void* stream)
{
    return launch<double, double>(
        X, recs, leaf_vals, tree_rec, tree_val, chunk_tree, col_chunk, init,
        out, n_rows, n_feat, n_out, n_steps, rows_per_block,
        threads_per_row, row_groups, trees_per_pass, stage_tables,
        table_bytes, stage_x, x_stride, threads, smem, stream);
}

int mpt_margin_q(const void* X, const void* recs, const void* leaf_vals,
                 const void* tree_rec, const void* tree_val,
                 const void* chunk_tree, const void* col_chunk,
                 const void* init, void* out, int n_rows, int n_feat,
                 int n_out, int n_steps, int rows_per_block,
                 int threads_per_row, int row_groups, int trees_per_pass,
                 int stage_tables, int table_bytes, int stage_x,
                 int x_stride, int threads, int smem, void* stream)
{
    return launch<int8_t, int32_t>(
        X, recs, leaf_vals, tree_rec, tree_val, chunk_tree, col_chunk, init,
        out, n_rows, n_feat, n_out, n_steps, rows_per_block,
        threads_per_row, row_groups, trees_per_pass, stage_tables,
        table_bytes, stage_x, x_stride, threads, smem, stream);
}

const char* mpt_margin_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
