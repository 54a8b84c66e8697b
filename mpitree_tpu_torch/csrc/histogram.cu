// Payload histogram kernels for Hopper (sm_90a): the (slot, feature,
// channel, bin) histogram every tree level needs.
//
//   out[s, f, c, b] += payload[r, c]   for every row r with
//                      slot[r] == s in [0, S) and xb[r, f] == b in [0, B)
//
// They replace the three TPU kernels of the JAX package, which compute this
// one function at different frontier widths: K1
// (mpitree_tpu/ops/pallas_hist.py, _hist_kernel, one block, tiny S), K2
// (same file, _hist_kernel_fgrid, S = 64..128) and K3
// (mpitree_tpu/ops/wide_hist.py, _wide_kernel, S >= 256, rows sorted by slot
// and window-packed by XLA code outside the kernel). The TPU kernels turn the
// scatter into one-hot matrix products; Hopper has float atomics in shared
// memory at one instruction per add, so these kernels scatter.
//
// Layouts (row-major, contiguous): xb (N, row_stride) bin ids, either int32
// (row_stride = F) or uint8 with rows padded to a multiple of 16 bytes
// (ops/hist_kernel.pack_bins); payload (N, C) float32; slot (N,) int32; out
// (S, F, C, B) float32, or int64 in fixed-point mode (below). Rows whose slot
// lies outside [0, S) add nothing; bin ids at or above a feature's bin count
// add nothing.
//
// What bounds the function on an H100: bytes. A pass must read each row's
// bins and payload once and write the S*F*C*B*4-byte output once (0.79 GB at
// S = 2048, F = 54, C = 7, B = 256: sixteen times the L2). What the design
// does about it:
//
// hist_tile_kernel — one body for every width.
//   * Privatized in shared memory. A block owns a tile of one slot (sorted)
//     or of all S slots (stream) for one feature group, adds its rows into
//     it with shared-memory atomics, and flushes it once. The tile is
//     ragged: per channel one row in which feature f has (nb[f] | 1) cells,
//     nb[f] its own bin count, so covtype's 10 wide and 44 two-bin columns
//     fit one 74 KB tile and a row is read by one block only. The odd cell
//     counts spread the features over the banks.
//   * Sorted route (S >= 2): the caller orders the rows by slot (order,
//     seg_start; the counterpart of K3's _sort_and_pack), so a block reads
//     only its own slot's rows. A slot of at most piece_rows rows is owned by
//     one block, which writes out[s] with plain 16-byte streaming stores,
//     zeros included: no zero fill, no global atomic, the output is written
//     exactly once. A longer slot is split into pieces of piece_rows rows;
//     hist_zero_split_kernel zeroes such slots first and their pieces add
//     their nonzero cells with global atomics. Which block takes which
//     piece is decided on the device from seg_start alone (see the decode
//     below), so a launch needs no host synchronisation.
//   * Stream route (S = 1, or any S whose tiles fit together): no sort; the
//     rows are taken in storage order in pieces of piece_rows, each row's
//     slot is read, and all pieces combine through global atomics into a
//     zeroed output (nonzero cells only).
//   * Wide loads, few instructions an add. A thread takes the same 16
//     features of every row it handles: one 16-byte load of byte-wide bins
//     feeds 16 adds, and the features' tile offsets and bin counts stay in
//     16 registers, so an add costs a byte extract, a compare, an address
//     and the atomic. Rows in flight come from the 32 resident warps of an
//     SM (two blocks of 512 threads at 60 registers); unrolling a thread
//     over 2-4 rows measured slower (register spills) and is not done.
//   * The payload once per row. Before the adds one thread per row scans
//     the row's C payload values and leaves its nonzero channel and value
//     in shared memory for the threads that take the row's features; a row
//     with one nonzero channel (a class payload) costs one add per feature,
//     rows with several keep the general loop over the channels.
//   * Integer adds. A float atomic in shared memory is a compare-and-swap
//     loop; a 32-bit integer one is native. If the scan finds only small
//     integers (class counts and integer weights: every fit on the card)
//     the block adds integers and converts when it flushes, else floats.
//
// The first design (one thread per (row, feature), global float atomics
// straight into a zeroed output, and a float shared-memory tile at S = 1)
// lost to these routes at every width on the card and is gone (PERF.md).
//
// Exactness: for integer-valued payloads whose sums stay below 2^24 every
// partial sum is exact in float32, so the result does not depend on the order
// of the atomics and is bit-identical to the plain version. Output offsets
// are 64-bit; element ids are 32-bit, N * F < 2^31 (checked by the wrapper).
//
// Fixed-point mode (kFixed; every non-integer payload: fractional weights,
// regression moments, GBDT (count, g, h)). Float atomics add in an order
// that changes from run to run, so a float sum of fractions, and with it a
// near-tie split, could too. In this mode every value becomes a signed
// 64-bit integer q = rint(v * 2^k[c]) (round half to even, in float64,
// where the product of a float32 v and a power of two is exact), and the
// tile and the output hold int64 sums. Shared memory has no native 64-bit
// integer add on sm_90 (atomicAdd on an unsigned long long there compiles
// to a compare-and-swap loop, as a float add in shared memory does), so a
// tile cell is two 32-bit words added with two native 32-bit atomics and
// the low word's carry (add_fixed); device memory has a native 64-bit
// add, which the split slots' flush uses. Integer addition is associative,
// so every launch, every route and the plain version give the same bits. The wrapper passes scale[c] = 2^k[c], fixed once per fit from
// the channel's largest |v| and the row count so that no partial sum can
// reach 2^63 (ops/hist_kernel.fixed_point_exponents). The sums are exact
// whenever every value is a multiple of 2^-k[c]: float32 weights within a
// ratio of about 2^17 of each other at covtype's row count are. They stop
// being exact for the tiny values of a channel whose largest value is far
// larger, such as w*y^2 for targets near the mean: such a value is rounded
// to the nearest multiple of 2^-k[c] (an absolute error below 2^-(k[c]+1)
// a row), deterministically. The cells double to 8 bytes, so covtype's
// 74 KB tile becomes 148 KB and one block runs per SM.
//
// The launch functions return cudaGetLastError() after the launch and
// allocate nothing; the caller passes the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kLaneFeat = 16;  // features of a row one thread takes

// A row's code in shared memory: channel in the low byte (kNone: nothing to
// add; kSeveral: more than one nonzero channel, or a channel id that does not
// fit the byte), slot above it.
constexpr int kNone = 255;
constexpr int kSeveral = 254;

// Size of a group's (tile offset, bin count) table, 16-byte rounded.
__host__ __device__ constexpr int feat_bytes(int n)
{
    return (n * 8 + 15) & ~15;
}

// Adds the int64 q (as two's complement) to the fixed-point tile cell at c:
// its low word c[0], its high word c[1]. Two native 32-bit shared atomics;
// the high word also takes the low word's carry, read off the value the
// low add returns. Each add of a low word below 2^32 wraps it at most once,
// so the carries count its wraps exactly, whatever the order of the adds:
// the cell ends with the exact sum mod 2^64.
__device__ __forceinline__ void add_fixed(unsigned* c, unsigned long long q)
{
    const unsigned lo = (unsigned)q;
    unsigned hi = (unsigned)(q >> 32);
    if (lo) {
        const unsigned old = atomicAdd(c, lo);
        hi += (unsigned)(old + lo < old);  // the low word wrapped
    }
    if (hi) atomicAdd(c + 1, hi);
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

// layout (int32): [0, G] feature-group starts; [G+1, 2G] cells of one
// slot's tile per group (C channel rows); then per feature (offset within
// a channel row of its group, bin count). out_raw is float32, or int64 in
// fixed-point mode (kFixed), the only mode that reads scale.
template <typename BinT, bool kSorted, bool kFixed>
__global__ void __launch_bounds__(kMaxThreads)
hist_tile_kernel(const BinT* __restrict__ xb,
                 const float* __restrict__ payload,
                 const int32_t* __restrict__ slot,
                 const int32_t* __restrict__ order,
                 const int32_t* __restrict__ seg,
                 const int32_t* __restrict__ layout,
                 const double* __restrict__ scale,
                 void* __restrict__ out_raw,
                 int n_rows, int row_stride, int n_feat, int n_chan,
                 int n_bins, int n_slots, int n_groups, int piece_rows)
{
    // Shared memory: the group's (tile offset, bin count) pairs, one
    // (slot and channel code, value) pair per row of the piece, the tile.
    extern __shared__ __align__(16) unsigned char smem[];
    const int g = blockIdx.y;
    const int f0 = layout[g];
    const int fc = layout[g + 1] - f0;
    const int gcells = layout[n_groups + 1 + g];
    const int rowcells = gcells / n_chan;  // one channel's row of the tile
    int2* feat = reinterpret_cast<int2*>(smem);
    int2* code = reinterpret_cast<int2*>(smem + feat_bytes(fc));
    float* tile = reinterpret_cast<float*>(code + piece_rows);
    unsigned* qtile = reinterpret_cast<unsigned*>(code + piece_rows);
    const int cell_bytes = kFixed ? 8 : 4;

    // Which rows this block takes: positions [a, b) of `order` (sorted) or
    // of the rows themselves (stream). Sorted: block v < S takes the first
    // piece_rows rows of slot v and owns the slot when it has no more; a
    // further piece of slot s starts at q = seg[s] + k * piece_rows (k >= 1,
    // q < seg[s + 1]) and is taken by block S + (q - seg[0]) / piece_rows:
    // at most one such q falls into any stretch of piece_rows positions,
    // because a slot has one only when it is longer than that.
    int own = 0, a, b;
    bool owned = false;
    if (kSorted) {
        const int v = blockIdx.x;
        if (v < n_slots) {
            own = v;
            a = seg[v];
            const int end = seg[v + 1];
            owned = end - a <= piece_rows;
            b = owned ? end : a + piece_rows;
        } else {
            const int pos = seg[0] + (v - n_slots) * piece_rows;
            if (pos >= seg[n_slots]) return;
            int lo = 0, hi = n_slots;  // last s with seg[s] <= pos
            while (hi - lo > 1) {
                const int mid = (lo + hi) >> 1;
                if (seg[mid] <= pos) lo = mid; else hi = mid;
            }
            const int k = (pos - seg[lo] + piece_rows - 1) / piece_rows;
            a = seg[lo] + k * piece_rows;
            if (k == 0 || a >= seg[lo + 1]) return;
            own = lo;
            b = min(a + piece_rows, seg[lo + 1]);
        }
    } else {
        a = blockIdx.x * piece_rows;
        b = min(n_rows, a + piece_rows);
        if (a >= b) return;
    }

    const int tile_slots = kSorted ? 1 : n_slots;
    for (int i = threadIdx.x; i < fc; i += blockDim.x)
        feat[i] = make_int2(layout[2 * n_groups + 1 + 2 * (f0 + i)],
                            layout[2 * n_groups + 2 + 2 * (f0 + i)]);
    {
        uint4* t4 = reinterpret_cast<uint4*>(tile);
        // the tile is padded to 16 bytes
        const int n4 = (tile_slots * gcells * cell_bytes + 15) >> 4;
        for (int i = threadIdx.x; i < n4; i += blockDim.x)
            t4[i] = make_uint4(0u, 0u, 0u, 0u);
    }

    // Each row's payload is scanned once, by one thread: its nonzero
    // channel and value (or "none" / "several") go to shared memory with
    // its slot, for the threads that take the row's features. The same
    // scan decides the block's mode: if every value is a small integer the
    // block adds integers (piece_rows * 65536 cannot wrap) and converts at
    // the flush, else it adds floats. Fixed-point mode always adds int64.
    bool ok = true;
    for (int i = threadIdx.x; i < b - a; i += blockDim.x) {
        const int r = kSorted ? __ldg(order + a + i) : a + i;
        int s = 0;
        if (!kSorted) s = __ldg(slot + r);
        int ch = kNone;
        float val = 0.f;
        if (s >= 0 && s < n_slots) {
            const float* p = payload + (int64_t)r * n_chan;
            for (int c = 0; c < n_chan; ++c) {
                const float v = __ldg(p + c);
                if (v == 0.0f) continue;
                ok = ok && v == rintf(v) && fabsf(v) <= 65536.0f;
                ch = ch == kNone && c < kSeveral ? c : kSeveral;
                val = v;
            }
        }
        code[i] = make_int2((s << 8) | ch, __float_as_int(val));
    }
    const bool fractional = __syncthreads_or(!ok);  // also the barrier
    const bool int_mode = !kFixed && !fractional;
    int* itile = reinterpret_cast<int*>(tile);

    // A thread keeps one 16-feature lane of the rows it takes, so its 16
    // (tile offset << 16 | bin count) words stay in registers; a feature
    // outside the group gets bin count 0 and is never added.
    const int q0 = f0 / kLaneFeat;
    const int lpr = (f0 + fc - 1) / kLaneFeat - q0 + 1;  // lanes per row
    const int rpp = blockDim.x / lpr;                    // rows per pass
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
    const int n_piece = rt < rpp ? b - a : 0;
    for (int rl = rt; rl < n_piece; rl += rpp) {
        const int2 cd = code[rl];
        const int ch = cd.x & 255;
        if (ch == kNone) continue;
        const int row = kSorted ? __ldg(order + a + rl) : a + rl;
        RowBins<BinT> bins;
        bins.load(xb + (int64_t)row * row_stride, flo, n_feat);
        const int tb = (cd.x >> 8) * gcells;
        const float val = __int_as_float(cd.y);
        if (ch == kSeveral) {
            const float* p = payload + (int64_t)row * n_chan;
#pragma unroll
            for (int j = 0; j < kLaneFeat; ++j) {
                const unsigned bin = bins.get(j);
                if (bin >= (ft[j] & 0xffffu)) continue;
                const int cell = tb + (int)(ft[j] >> 16) + (int)bin;
                for (int c = 0; c < n_chan; ++c) {
                    const float v = __ldg(p + c);
                    if (v == 0.0f) continue;
                    if (kFixed)
                        add_fixed(qtile + 2 * (cell + c * rowcells),
                                  (unsigned long long)__double2ll_rn(
                                      (double)v * __ldg(scale + c)));
                    else if (int_mode)
                        atomicAdd(itile + cell + c * rowcells,
                                  __float2int_rn(v));
                    else atomicAdd(tile + cell + c * rowcells, v);
                }
            }
        } else if (kFixed) {
            unsigned* t = qtile + 2 * (tb + ch * rowcells);
            const unsigned long long q = (unsigned long long)__double2ll_rn(
                (double)val * __ldg(scale + ch));
#pragma unroll
            for (int j = 0; j < kLaneFeat; ++j) {
                const unsigned bin = bins.get(j);
                if (bin < (ft[j] & 0xffffu))
                    add_fixed(t + 2 * ((ft[j] >> 16) + bin), q);
            }
        } else if (int_mode) {
            int* t = itile + tb + ch * rowcells;
            const int ival = __float2int_rn(val);
#pragma unroll
            for (int j = 0; j < kLaneFeat; ++j) {
                const unsigned bin = bins.get(j);
                if (bin < (ft[j] & 0xffffu))
                    atomicAdd(t + (ft[j] >> 16) + bin, ival);
            }
        } else {
            float* t = tile + tb + ch * rowcells;
#pragma unroll
            for (int j = 0; j < kLaneFeat; ++j) {
                const unsigned bin = bins.get(j);
                if (bin < (ft[j] & 0xffffu))
                    atomicAdd(t + (ft[j] >> 16) + bin, val);
            }
        }
    }
    __syncthreads();

    // Flush. An owned slot is stored whole, zeros included; a piece adds
    // its nonzero cells.
    const int64_t slot_cells = (int64_t)n_feat * n_chan * n_bins;
    const int64_t goff = (int64_t)f0 * n_chan * n_bins;
    const int lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    const int n_trows = fc * n_chan;  // (feature, channel) rows of a tile
    if (kFixed) {
        long long* out = reinterpret_cast<long long*>(out_raw);
        const long long* qt = reinterpret_cast<const long long*>(qtile);
        if (owned) {
            long long* o = out + own * slot_cells + goff;
            // a warp writes one (feature, channel) row of B bins at a time
            for (int r = threadIdx.x >> 5; r < n_trows; r += n_warps) {
                const int fl = r / n_chan;
                const int2 fo = feat[fl];
                const long long* t = qt + (r - fl * n_chan) * rowcells + fo.x;
                long long* orow = o + (int64_t)r * n_bins;
                if ((n_bins & 1) == 0) {
                    for (int bin = lane * 2; bin < n_bins; bin += 64) {
                        longlong2 v;
                        v.x = bin < fo.y ? t[bin] : 0ll;
                        v.y = bin + 1 < fo.y ? t[bin + 1] : 0ll;
                        *reinterpret_cast<longlong2*>(orow + bin) = v;
                    }
                } else {
                    for (int bin = lane; bin < n_bins; bin += 32)
                        orow[bin] = bin < fo.y ? t[bin] : 0ll;
                }
            }
            return;
        }
        for (int sl = 0; sl < tile_slots; ++sl) {
            const int s = kSorted ? own : sl;
            unsigned long long* o = reinterpret_cast<unsigned long long*>(
                out + s * slot_cells + goff);
            const long long* ts = qt + sl * gcells;
            for (int r = threadIdx.x >> 5; r < n_trows; r += n_warps) {
                const int fl = r / n_chan;
                const int2 fo = feat[fl];
                const long long* t = ts + (r - fl * n_chan) * rowcells + fo.x;
                unsigned long long* orow = o + (int64_t)r * n_bins;
                for (int bin = lane; bin < fo.y; bin += 32) {
                    const long long v = t[bin];
                    if (v != 0) atomicAdd(orow + bin, (unsigned long long)v);
                }
            }
        }
        return;
    }
    float* out = reinterpret_cast<float*>(out_raw);
    auto cell = [int_mode](const float* t) {
        return int_mode ? (float)*reinterpret_cast<const int*>(t) : *t;
    };
    if (owned) {
        float* o = out + own * slot_cells + goff;
        // a warp writes one (feature, channel) row of B bins at a time
        for (int r = threadIdx.x >> 5; r < n_trows; r += n_warps) {
            const int fl = r / n_chan;
            const int2 fo = feat[fl];
            const float* t = tile + (r - fl * n_chan) * rowcells + fo.x;
            float* orow = o + (int64_t)r * n_bins;
            if ((n_bins & 3) == 0) {
                for (int bin = lane * 4; bin < n_bins; bin += 128) {
                    float4 v;
                    v.x = bin < fo.y ? cell(t + bin) : 0.f;
                    v.y = bin + 1 < fo.y ? cell(t + bin + 1) : 0.f;
                    v.z = bin + 2 < fo.y ? cell(t + bin + 2) : 0.f;
                    v.w = bin + 3 < fo.y ? cell(t + bin + 3) : 0.f;
                    __stcs(reinterpret_cast<float4*>(orow + bin), v);
                }
            } else {
                for (int bin = lane; bin < n_bins; bin += 32)
                    orow[bin] = bin < fo.y ? cell(t + bin) : 0.f;
            }
        }
        return;
    }
    for (int sl = 0; sl < tile_slots; ++sl) {
        const int s = kSorted ? own : sl;
        float* o = out + s * slot_cells + goff;
        const float* ts = tile + sl * gcells;
        for (int r = threadIdx.x >> 5; r < n_trows; r += n_warps) {
            const int fl = r / n_chan;
            const int2 fo = feat[fl];
            const float* t = ts + (r - fl * n_chan) * rowcells + fo.x;
            float* orow = o + (int64_t)r * n_bins;
            for (int bin = lane; bin < fo.y; bin += 32) {
                const float v = cell(t + bin);
                if (v != 0.0f) atomicAdd(orow + bin, v);
            }
        }
    }
}

// Zeroes out[s] (slot_bytes bytes a slot) for every slot that the sorted
// route splits into pieces.
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
    } else {  // 4-byte cells, slot_cells not a multiple of 4
        unsigned* o1 = reinterpret_cast<unsigned*>(o);
        for (int64_t i = first; i < (slot_bytes >> 2); i += step) o1[i] = 0u;
    }
}

template <typename BinT, bool kSorted, bool kFixed>
int launch_tile(const void* xb, const void* payload, const void* slot,
                const void* order, const void* seg, const void* layout,
                const void* scale, void* out, int n_rows, int row_stride,
                int n_feat, int n_chan, int n_bins, int n_slots,
                int n_groups, int piece_rows, int n_blocks, int threads,
                int smem_bytes, cudaStream_t stream)
{
    // the opt-in above 48 KB of dynamic shared memory is per instantiation
    cudaError_t e = cudaFuncSetAttribute(
        hist_tile_kernel<BinT, kSorted, kFixed>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    hist_tile_kernel<BinT, kSorted, kFixed>
        <<<dim3(n_blocks, n_groups), threads, smem_bytes, stream>>>(
        (const BinT*)xb, (const float*)payload, (const int32_t*)slot,
        (const int32_t*)order, (const int32_t*)seg, (const int32_t*)layout,
        (const double*)scale, out, n_rows, row_stride, n_feat, n_chan,
        n_bins, n_slots, n_groups, piece_rows);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bin_bytes 1 (uint8 rows of row_stride bytes) or 4 (int32); sorted != 0
// takes order/seg and writes every cell of `out`; sorted == 0 reads slot
// and adds into a zeroed `out`. fixed != 0: fixed-point mode, `scale` holds
// n_chan float64 scales 2^k[c] and `out` is int64, else `out` is float32
// and `scale` is not read.
int mpt_hist_tile(const void* xb, const void* payload, const void* slot,
                  const void* order, const void* seg, const void* layout,
                  const void* scale, void* out, int n_rows, int row_stride,
                  int n_feat, int n_chan, int n_bins, int n_slots,
                  int n_groups, int piece_rows, int n_blocks, int threads,
                  int smem_bytes, int bin_bytes, int sorted, int fixed,
                  void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    if (sorted) {
        hist_zero_split_kernel<<<dim3(n_slots, 8), 256, 0, st>>>(
            (const int32_t*)seg, (unsigned char*)out, piece_rows,
            (int64_t)n_feat * n_chan * n_bins * (fixed ? 8 : 4));
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
#define MPT_TILE(BinT, kSorted, kFixed) \
    launch_tile<BinT, kSorted, kFixed>(xb, payload, slot, order, seg, \
        layout, scale, out, n_rows, row_stride, n_feat, n_chan, n_bins, \
        n_slots, n_groups, piece_rows, n_blocks, threads, smem_bytes, st)
#define MPT_ROUTE(BinT) \
    (fixed ? (sorted ? MPT_TILE(BinT, true, true) \
                     : MPT_TILE(BinT, false, true)) \
           : (sorted ? MPT_TILE(BinT, true, false) \
                     : MPT_TILE(BinT, false, false)))
    if (bin_bytes == 1) return MPT_ROUTE(uint8_t);
    return MPT_ROUTE(int32_t);
#undef MPT_ROUTE
#undef MPT_TILE
}

const char* mpt_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
