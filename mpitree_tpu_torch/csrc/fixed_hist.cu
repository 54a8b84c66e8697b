// The fixed-point payload histogram for Hopper (sm_90a): routes
// stream_fixed and sorted_fixed of ops/hist_kernel.py.
//
//   out[s, f, c, b] += rint(payload[r, c] * 2^k[c])   (int64) for every row
//                      r with slot[r] == s in [0, S) and xb[r, f] == b
//
// The function is that of csrc/histogram.cu (K1-K3 of the JAX package:
// mpitree_tpu/ops/pallas_hist.py _hist_kernel and _hist_kernel_fgrid,
// mpitree_tpu/ops/wide_hist.py _wide_kernel) for the payloads that are not
// small integers, which mpitree_tpu/ops/pallas_hist.py:245-266 hands the
// same TPU kernels: fractional class weights, the regression moments
// (w, w*y, w*y^2) and GBDT's (count, g, h). Every value becomes a signed
// 64-bit integer q = rint(v * 2^k[c]) (round half to even, in float64,
// where the product of a float32 v and a power of two is exact) and the
// histogram holds int64 sums. Integer addition does not depend on its
// order, so every launch, both routes and the plain version
// (ops/hist_kernel.histogram_reference) give the same bits. The wrapper
// passes scale[c] = 2^k[c], fixed once per fit so that no partial sum can
// reach 2^63 (ops/hist_kernel.fixed_point_exponents: |q| <
// 2^(62 - ceil(log2 N)) for N rows). The sums are exact whenever every
// value is a multiple of 2^-k[c]: float32 weights within a ratio of about
// 2^17 of each other at covtype's row count are. They stop being exact for
// the tiny values of a channel whose largest value is far larger, such as
// w*y^2 for targets near the mean: such a value is rounded to the nearest
// multiple of 2^-k[c] (an absolute error below 2^-(k[c]+1) a row),
// deterministically.
//
// Layouts as in csrc/histogram.cu: xb (N, row_stride) int32 or uint8 bins
// (rows padded to 16 bytes), payload (N, C) float32, slot (N,) int32, out
// (S, F, C, B) int64; the tile is ragged (feature f takes nb[f] | 1 cells
// of each channel row) and a thread takes the same 16 features of every row
// it handles.
//
// What bounds it on an H100: bytes, as for the integer routes (each row's
// bins, payload and slot read once, the int64 output written once). What
// this body does about the costs the fixed-point mode had as a flag on the
// integer body of csrc/histogram.cu (PERF.md):
//
//   * Quantized once per row. Rows are taken in batches of one row a
//     thread: the thread that scans a row reads its slot and its C values,
//     converts them once, and leaves (row, tile base, q[0..kChan)) in
//     shared memory for the threads that take the row's features; rows out
//     of range or with nothing to add are dropped there (a warp-aggregated
//     count compacts the batch), so the add phase sees live rows only.
//     kChan is a compile-time 3 (moments and GBDT: three channels, the
//     loop unrolled, a zero q skipped) or 1 (one nonzero channel a row:
//     class payloads of any C; a row with several nonzero channels, which
//     no class payload has, is added whole by the thread that scanned it).
//     The staging takes 16 or 32 bytes a thread, not 8 bytes a row of the
//     piece, so a piece is no longer bounded by shared memory.
//   * Two ways to add a q, both with native 32-bit shared atomics and no
//     compare-and-swap loop. Shared memory has no native 64-bit integer
//     add on sm_90a: atomicAdd on an unsigned long long there,
//     red.shared.add.u64, and a 64-bit add through the block's own
//     address in the cluster window (mapa, atom/red.shared::cluster) all
//     compile to ATOMS.CAST.SPIN.64, a compare-and-swap loop, beside the
//     native ATOM.E.ADD.64 that only a peer block's address takes
//     (cuobjdump of sm_90a builds; PERF.md).
//     - carry (kLimbs false): a cell is two 32-bit words; the high word's
//       add waits on the low add's returned value for the carry
//       (add_carry). 8 bytes a cell.
//     - limbs (kLimbs true): q is cut into bits 0-15, 16-31 and 32-63,
//       added into three planes with three independent atomics and
//       combined into the int64 at the flush (add_q, cell_value). The two
//       16-bit limbs' sums stay exact for up to 65,537 adds a cell, so a
//       block takes at most 65,536 rows (ops/hist_kernel.LIMB_MAX_ROWS);
//       the top limb needs only its sum mod 2^32, since the cell's sum is
//       kept mod 2^64 and is below 2^63 by the exponents. 12 bytes a
//       cell.
//     On an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md) limbs win where
//     most features have few bins, so that many rows' adds meet in the
//     same cells and the carry's dependent add waits longest: GBDT on
//     covtype's 54 features 4-29% faster, fractional class weights there
//     2-17% (S = 1 and 8-512). They lose 0-7% on 8 features of about 256
//     bins each (moments, GBDT) and 13% on the covtype class tile at
//     S = 2, where 12-byte cells take a third feature group. The planner
//     takes limbs where at least half the features have at most 16 bins
//     and the limb tile needs no more feature groups
//     (ops/hist_kernel.LIMBS_FEW_BINS).
//   * Residency. The planner (ops/hist_kernel._fixed_plan) prices the small
//     staging: with as few feature groups as fit, the stream route takes
//     one block of 1024 threads an SM, the sorted route two of 512 where
//     they fit, else one of 1024 (the measured order; a 151 KB covtype
//     class tile runs 32 warps an SM where the flag's body ran 16).
//   * Fewer global atomics at S <= 2. The stream route runs one wave of
//     blocks for each feature group (132 on an H100), each over its share
//     of the rows in batches, so a cell takes one global atomic a block,
//     not one a piece of at most 4,096 rows; a frontier with few live rows
//     (a leaf-wise sibling pair) costs its slot reads and little more.
//     Half and twice as many blocks measured slower, but for the two-group
//     covtype class tile at S = 2, where a wave a group (two in all) beat
//     half a wave each. The sorted route keeps the integer body's decode:
//     a slot one block owns is stored whole with plain stores, zeros
//     included; a longer slot's pieces add their nonzero cells into the
//     slot, zeroed first by hist_zero_split_kernel.
//
// Candidates that lost at every width (PERF.md; NVIDIA H100 80GB HBM3,
// 700.00 W): a combine of the stream tiles over distributed shared memory
// in clusters of 2, 4 or 8 blocks (2: within 3% either way; 4, 8:
// slower), and 512 threads for the stream route (as fast at best). The
// 64-bit adds through the cluster window were up to 35% faster but are a
// compare-and-swap loop, which the fixed tiles must not be.
//
// The launch function returns cudaGetLastError() after the launches,
// allocates nothing, and takes the caller's stream: a CUDA graph may
// capture it. Element ids are 32-bit (N * F < 2^31, checked by the
// wrapper); output offsets are 64-bit.

#include "hist_tiles.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// Adds the int64 q (two's complement) to the tile cell at c: low word c[0],
// high word c[1]. Two native 32-bit shared atomics; the high word also
// takes the low word's carry, read off the value the low add returns. Each
// add of a low word below 2^32 wraps it at most once, so the carries count
// its wraps exactly, whatever the order of the adds: the cell ends with
// the exact sum mod 2^64.
__device__ __forceinline__ void add_carry(unsigned* c, unsigned long long q)
{
    const unsigned lo = (unsigned)q;
    unsigned hi = (unsigned)(q >> 32);
    if (lo) {
        const unsigned old = atomicAdd(c, lo);
        hi += (unsigned)(old + lo < old);  // the low word wrapped
    }
    if (hi) atomicAdd(c + 1, hi);
}

// Adds q to cell i of a tile: carry mode, two words a cell (add_carry);
// limb mode, three planes of `plane` words: bits 0-15 and 16-31 of q,
// each summed exactly (65,537 adds of a 16-bit limb stay below 2^32; the
// planner gives a block at most ops/hist_kernel.LIMB_MAX_ROWS rows, and a
// row adds to a cell once), and bits 32-63, summed mod 2^32. The three
// adds are independent of each other.
template <bool kLimbs>
__device__ __forceinline__ void add_q(unsigned* tile, int plane, int i,
                                      unsigned long long q)
{
    if (kLimbs) {
        const unsigned l0 = (unsigned)q & 0xffffu;
        const unsigned l1 = (unsigned)q >> 16;
        const unsigned l2 = (unsigned)(q >> 32);
        if (l0) atomicAdd(tile + i, l0);
        if (l1) atomicAdd(tile + plane + i, l1);
        if (l2) atomicAdd(tile + 2 * plane + i, l2);
    } else {
        add_carry(tile + 2 * i, q);
    }
}

// The int64 sum in cell i: sum0 + sum1 * 2^16 + sum2 * 2^32 mod 2^64 in
// limb mode, which is the exact sum whenever that fits an int64.
template <bool kLimbs>
__device__ __forceinline__ long long cell_value(const unsigned* tile,
                                                int plane, int i)
{
    if (kLimbs)
        return (long long)((unsigned long long)tile[i]
                           + ((unsigned long long)tile[plane + i] << 16)
                           + ((unsigned long long)tile[2 * plane + i] << 32));
    return reinterpret_cast<const long long*>(tile)[i];
}

// layout (int32), as csrc/histogram.cu reads it: [0, G] feature-group
// starts; [G+1, 2G] cells of one slot's tile per group (C channel rows);
// then per feature (offset within a channel row of its group, bin count).
template <typename BinT, bool kSorted, int kChan, bool kLimbs>
__global__ void __launch_bounds__(kMaxThreads)
fixed_tile_kernel(const BinT* __restrict__ xb,
                  const float* __restrict__ payload,
                  const int32_t* __restrict__ slot,
                  const int32_t* __restrict__ order,
                  const int32_t* __restrict__ seg,
                  const int32_t* __restrict__ layout,
                  const double* __restrict__ scale,
                  long long* __restrict__ out,
                  int n_rows, int row_stride, int n_feat, int n_chan,
                  int n_bins, int n_slots, int n_groups, int piece_rows)
{
    // Shared memory: the group's (tile offset, bin count) pairs; the
    // batch's (row, tile base) pairs and kChan q values a thread; the tile
    // (two 32-bit words a cell, or three planes of one); two counters.
    extern __shared__ __align__(16) unsigned char smem[];
    const int nt = blockDim.x;
    const int g = blockIdx.y;
    const int f0 = layout[g];
    const int fc = layout[g + 1] - f0;
    const int gcells = layout[n_groups + 1 + g];
    const int rowcells = gcells / n_chan;  // one channel's row of the tile
    const int tile_slots = kSorted ? 1 : n_slots;
    const int tile_cells = tile_slots * gcells;
    int2* feat = reinterpret_cast<int2*>(smem);
    int2* stage = reinterpret_cast<int2*>(smem + feat_bytes(fc));
    long long* sq = reinterpret_cast<long long*>(stage + nt);
    unsigned* tile = reinterpret_cast<unsigned*>(sq + kChan * nt);
    const int plane = (tile_cells + 3) & ~3;  // limb mode's plane, 16 B
    const int tile_words = kLimbs ? 3 * plane : (2 * tile_cells + 3) & ~3;
    int* count = reinterpret_cast<int*>(tile + tile_words);

    // Which rows: positions [a, b) of `order` (sorted: sorted_piece) or of
    // the rows (stream: block v takes [v * piece_rows, (v + 1) *
    // piece_rows)).
    int own = 0, a = 0, b = 0;
    bool owned = false;
    if (kSorted) {
        if (!sorted_piece(seg, n_slots, piece_rows, blockIdx.x, own, a, b,
                          owned))
            return;
    } else {
        a = blockIdx.x * piece_rows;
        b = min(n_rows, a + piece_rows);
        if (a >= b) return;
    }

    for (int i = threadIdx.x; i < fc; i += nt)
        feat[i] = make_int2(layout[2 * n_groups + 1 + 2 * (f0 + i)],
                            layout[2 * n_groups + 2 + 2 * (f0 + i)]);
    {
        uint4* t4 = reinterpret_cast<uint4*>(tile);
        const int n4 = tile_words >> 2;
        for (int i = threadIdx.x; i < n4; i += nt)
            t4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (threadIdx.x < 2) count[threadIdx.x] = 0;
    __syncthreads();

    // A thread keeps one 16-feature lane of the rows it adds, its 16
    // (tile offset << 16 | bin count) words in registers; a feature
    // outside the group gets bin count 0 and is never added.
    const int q0 = f0 / kLaneFeat;
    const int lpr = (f0 + fc - 1) / kLaneFeat - q0 + 1;  // lanes per row
    const int rpp = nt / lpr;                            // rows per pass
    const int rt = threadIdx.x / lpr;
    const int flo = (q0 + (int)threadIdx.x - rt * lpr) * kLaneFeat;
    unsigned ft[kLaneFeat];
#pragma unroll
    for (int j = 0; j < kLaneFeat; ++j) {
        const int fl = flo + j - f0;
        ft[j] = 0;
        if ((unsigned)fl < (unsigned)fc)
            ft[j] = ((unsigned)feat[fl].x << 16) | (unsigned)feat[fl].y;
    }
    const unsigned lane = threadIdx.x & 31;

    int par = 0;
    for (int base = a; base < b; base += nt) {
        // Scan: one row a thread, quantized once.
        const int i = base + (int)threadIdx.x;
        bool live = false;
        int r = 0, tb = 0;
        long long q[kChan];
#pragma unroll
        for (int c = 0; c < kChan; ++c) q[c] = 0;
        if (i < b) {
            r = kSorted ? __ldg(order + i) : i;
            const int s = kSorted ? 0 : __ldg(slot + r);
            if (s >= 0 && s < n_slots) {
                const float* p = payload + (int64_t)r * n_chan;
                if (kChan == 1) {
                    int ch = -1, nz = 0;
                    float val = 0.f;
                    for (int c = 0; c < n_chan; ++c) {
                        const float v = __ldg(p + c);
                        if (v != 0.0f) { ++nz; ch = c; val = v; }
                    }
                    if (nz == 1) {
                        q[0] = __double2ll_rn((double)val * __ldg(scale + ch));
                        live = q[0] != 0;
                        tb = s * gcells + ch * rowcells;
                    } else if (nz > 1) {
                        // several channels: this thread adds the row whole
                        const BinT* xr = xb + (int64_t)r * row_stride + f0;
                        for (int c = 0; c < n_chan; ++c) {
                            const float v = __ldg(p + c);
                            if (v == 0.0f) continue;
                            const unsigned long long qc =
                                (unsigned long long)__double2ll_rn(
                                    (double)v * __ldg(scale + c));
                            const int t = s * gcells + c * rowcells;
                            for (int fl = 0; fl < fc; ++fl) {
                                const unsigned bin = (unsigned)xr[fl];
                                const int2 fo = feat[fl];
                                if (bin < (unsigned)fo.y)
                                    add_q<kLimbs>(tile, plane,
                                                  t + fo.x + (int)bin, qc);
                            }
                        }
                    }
                } else {
#pragma unroll
                    for (int c = 0; c < kChan; ++c) {
                        q[c] = __double2ll_rn((double)__ldg(p + c)
                                              * __ldg(scale + c));
                        live = live || q[c] != 0;
                    }
                    tb = s * gcells;
                }
            }
        }
        // compaction: a warp takes its places with one shared atomic
        const unsigned m = __ballot_sync(0xffffffffu, live);
        if (m) {
            const int leader = __ffs(m) - 1;
            int at = 0;
            if ((int)lane == leader) at = atomicAdd(count + par, __popc(m));
            at = __shfl_sync(0xffffffffu, at, leader)
                 + __popc(m & ((1u << lane) - 1u));
            if (live) {
                stage[at] = make_int2(r, tb);
#pragma unroll
                for (int c = 0; c < kChan; ++c) sq[c * nt + at] = q[c];
            }
        }
        __syncthreads();
        const int n_live = count[par];
        if (threadIdx.x == 0) count[par ^ 1] = 0;

        // Adds: a row's lanes take its 16-feature slices.
        for (int rl = rt < rpp ? rt : n_live; rl < n_live; rl += rpp) {
            const int2 st = stage[rl];
            unsigned long long qq[kChan];
#pragma unroll
            for (int c = 0; c < kChan; ++c)
                qq[c] = (unsigned long long)sq[c * nt + rl];
            RowBins<BinT> bins;
            bins.load(xb + (int64_t)st.x * row_stride, flo, n_feat);
#pragma unroll
            for (int j = 0; j < kLaneFeat; ++j) {
                const unsigned bin = bins.get(j);
                if (bin >= (ft[j] & 0xffffu)) continue;
                const int cell = st.y + (int)(ft[j] >> 16) + (int)bin;
#pragma unroll
                for (int c = 0; c < kChan; ++c)
                    if (qq[c])
                        add_q<kLimbs>(tile, plane, cell + c * rowcells,
                                      qq[c]);
            }
        }
        __syncthreads();
        par ^= 1;
    }

    // Flush.
    const int64_t slot_cells = (int64_t)n_feat * n_chan * n_bins;
    const int64_t goff = (int64_t)f0 * n_chan * n_bins;
    const int n_warps = nt >> 5;
    const int n_trows = fc * n_chan;  // (feature, channel) rows of a tile
    auto qv = [&](int i) { return cell_value<kLimbs>(tile, plane, i); };
    if (kSorted) {
        if (owned) {
            long long* o = out + own * slot_cells + goff;
            // a warp writes one (feature, channel) row of B bins at a time
            for (int rw = threadIdx.x >> 5; rw < n_trows; rw += n_warps) {
                const int fl = rw / n_chan;
                const int2 fo = feat[fl];
                const int t = (rw - fl * n_chan) * rowcells + fo.x;
                long long* orow = o + (int64_t)rw * n_bins;
                if ((n_bins & 1) == 0) {
                    for (int bin = lane * 2; bin < n_bins; bin += 64) {
                        longlong2 v;
                        v.x = bin < fo.y ? qv(t + bin) : 0ll;
                        v.y = bin + 1 < fo.y ? qv(t + bin + 1) : 0ll;
                        __stcs(reinterpret_cast<longlong2*>(orow + bin), v);
                    }
                } else {
                    for (int bin = lane; bin < n_bins; bin += 32)
                        orow[bin] = bin < fo.y ? qv(t + bin) : 0ll;
                }
            }
            return;
        }
        unsigned long long* o = reinterpret_cast<unsigned long long*>(
            out + own * slot_cells + goff);
        for (int rw = threadIdx.x >> 5; rw < n_trows; rw += n_warps) {
            const int fl = rw / n_chan;
            const int2 fo = feat[fl];
            const int t = (rw - fl * n_chan) * rowcells + fo.x;
            unsigned long long* orow = o + (int64_t)rw * n_bins;
            for (int bin = lane; bin < fo.y; bin += 32) {
                const long long v = qv(t + bin);
                if (v != 0) atomicAdd(orow + bin, (unsigned long long)v);
            }
        }
        return;
    }

    // Stream: every piece adds its nonzero cells into the zeroed output.
    for (int it = threadIdx.x >> 5; it < tile_slots * n_trows;
         it += n_warps) {
        const int sl = it / n_trows;
        const int rw = it - sl * n_trows;
        const int fl = rw / n_chan;
        const int2 fo = feat[fl];
        const int t = sl * gcells + (rw - fl * n_chan) * rowcells + fo.x;
        unsigned long long* orow = reinterpret_cast<unsigned long long*>(
            out + sl * slot_cells + goff + (int64_t)rw * n_bins);
        for (int bin = lane; bin < fo.y; bin += 32) {
            const long long v = qv(t + bin);
            if (v != 0) atomicAdd(orow + bin, (unsigned long long)v);
        }
    }
}

template <typename BinT, bool kSorted, int kChan, bool kLimbs>
int launch(const void* xb, const void* payload, const void* slot,
           const void* order, const void* seg, const void* layout,
           const void* scale, void* out, int n_rows, int row_stride,
           int n_feat, int n_chan, int n_bins, int n_slots, int n_groups,
           int piece_rows, int n_blocks, int threads, int smem_bytes,
           cudaStream_t stream)
{
    // the opt-in above 48 KB of dynamic shared memory is per instantiation
    cudaError_t e = cudaFuncSetAttribute(
        fixed_tile_kernel<BinT, kSorted, kChan, kLimbs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    fixed_tile_kernel<BinT, kSorted, kChan, kLimbs>
        <<<dim3(n_blocks, n_groups), threads, smem_bytes, stream>>>(
        (const BinT*)xb, (const float*)payload, (const int32_t*)slot,
        (const int32_t*)order, (const int32_t*)seg, (const int32_t*)layout,
        (const double*)scale, (long long*)out, n_rows, row_stride, n_feat,
        n_chan, n_bins, n_slots, n_groups, piece_rows);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bin_bytes 1 (uint8 rows of row_stride bytes) or 4 (int32); chan 3 (the
// three-channel instance) or 1 (one nonzero channel a row); sorted != 0
// takes order/seg and writes every cell of `out`; sorted == 0 reads slot
// and adds into a zeroed `out`. scale holds n_chan float64 scales 2^k[c].
int mpt_fixed_tile(const void* xb, const void* payload, const void* slot,
                   const void* order, const void* seg, const void* layout,
                   const void* scale, void* out, int n_rows, int row_stride,
                   int n_feat, int n_chan, int n_bins, int n_slots,
                   int n_groups, int piece_rows, int n_blocks, int threads,
                   int smem_bytes, int bin_bytes, int chan, int sorted,
                   int limbs, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    if (sorted) {
        const cudaError_t e = zero_split_slots(
            seg, out, n_slots, piece_rows,
            (int64_t)n_feat * n_chan * n_bins * 8, st);
        if (e != cudaSuccess) return (int)e;
    }
#define MPT_FIXED(BinT, kSorted, kChan, kLimbs) \
    launch<BinT, kSorted, kChan, kLimbs>(xb, payload, slot, order, seg, \
        layout, scale, out, n_rows, row_stride, n_feat, n_chan, n_bins, \
        n_slots, n_groups, piece_rows, n_blocks, threads, smem_bytes, st)
#define MPT_ADDS(BinT, kSorted, kChan) \
    (limbs ? MPT_FIXED(BinT, kSorted, kChan, true) \
           : MPT_FIXED(BinT, kSorted, kChan, false))
#define MPT_CHAN(BinT, kSorted) \
    (chan == 3 ? MPT_ADDS(BinT, kSorted, 3) : MPT_ADDS(BinT, kSorted, 1))
#define MPT_ROUTE(BinT) \
    (sorted ? MPT_CHAN(BinT, true) : MPT_CHAN(BinT, false))
    if (bin_bytes == 1) return MPT_ROUTE(uint8_t);
    return MPT_ROUTE(int32_t);
#undef MPT_ROUTE
#undef MPT_CHAN
#undef MPT_ADDS
#undef MPT_FIXED
}

}  // extern "C"
