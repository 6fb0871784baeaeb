// First-k extraction of bit-packed match masks for Hopper (sm_90a): the one
// extraction kernel of every device path.
//
// Replaces vernemq_tpu/ops/match_kernel.py:225 extract_indices_packed, as the
// reference calls it from pallas_match.py:172 (the probe tiles),
// match_kernel.py:531 and :556 (window tiles, dense region 0) and
// reverse_kernel.py:194, :224 and :269 (the retained phases). XLA fuses its
// popcounts, prefix sums and bit select; in plain PyTorch they write [R, W]
// int64 temporaries to device memory.
//
// Function. For each output row r, source row src = rows[r] of the packed
// mask packed[R0][W] (bit j of word w is column 32·w + j) and live flag
// ok[r]: count[r] = the row's set bits (it may exceed k), idx[r][p] = the
// column of its p-th set bit for p < min(count, k), 0 past it, and
// valid[r][p] = p < count. A dead row counts 0 and reads nothing. rows and
// ok may be null: every row, all live. counts[R0][nb], when given, are the
// set bits of each 256-column chunk (8 words; the retained compare kernel
// writes them beside its words); without them the kernel counts the words
// itself, and W need not be a multiple of 8 (the last chunk is ragged).
//
// What bounds it: bytes. Without counts every live row's words are read
// once (probe A of the forward headline batch: 4096 rows of 8192 words, 134
// MB) and that read is the bound; with counts, the counts and the words of
// the chunks that hold the first k matches. The work per byte is a popcount
// and a shuffle scan, far below the card's integer rate.
//
// Design.
// - Lane = chunk: a warp takes a group of 32 chunks (256 words, 1 KB) as two
//   16-byte loads a lane, kG = 4 groups in flight per warp, and scans the
//   chunk counts by shuffles. Without counts the counts are the popcounts of
//   the loaded words, and the first k positions are emitted from the same
//   registers in the same pass: a row is read once. With counts only the
//   chunks that hold one of the first k matches load their words, and past
//   them a row's counts are only summed, 8 loads in flight a lane.
// - A long row is split over the warps of a block (S = 2, 4 or 8 warps a
//   row, chosen by the wrapper from R and the row's chunks, so that R·S
//   warps fill the card): each warp sums its span, the spans' totals are
//   scanned through shared memory, and each warp emits from its span's own
//   offset. The 224 rows of the retained dense launch get 1,792 warps, not
//   224. Without counts a split span must fit in the kG groups held in
//   registers, so it is read once; a longer row (or a launch with enough
//   rows) streams one warp a row. Short rows go 8 to a block, a warp each.
// - Emission is parallel: a group's words and the rank of each word's first
//   set bit go to the warp's shared memory; lane t finds target t's word by
//   a binary search over the 256 ranks and its bit by a popcount select, so
//   a chunk with many of the first k matches costs no serial loop, and the
//   idx rows are written coalesced. valid, the zero tail of idx and count
//   are written by the row's warps together.
// - At most 64 registers a thread, so 4 blocks (32 warps) fit an SM.
// - No TMA or cp.async ring: the loads are independent 16-byte loads with
//   kG groups in flight per warp and thousands of warps, enough to cover the
//   memory latency; a ring would add barrier work to a kernel that does
//   almost none.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerChunk = 8;                          // 256 columns
constexpr int kGroupWords = 32 * kWordsPerChunk;           // lane = chunk
constexpr int kGroupCols = kGroupWords * 32;
constexpr int kG = 4;                                      // groups in flight

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// Position of the set bit of rank r (0-based) in w, by halving.
__device__ __forceinline__ int select_bit(unsigned w, int r) {
    int pos = 0;
#pragma unroll
    for (int width = 16; width > 0; width >>= 1) {
        const unsigned low = w & ((1u << width) - 1u);
        const int n = __popc(low);
        if (r >= n) {
            r -= n;
            w >>= width;
            pos += width;
        } else {
            w = low;
        }
    }
    return pos;
}

// The 8 words of chunk c of a row; words at or past W read as 0.
__device__ __forceinline__ void load_chunk(const int* prow, int c, int W,
                                           bool vec, unsigned (&w)[8]) {
    const int base = c * kWordsPerChunk;
    if (vec && base + kWordsPerChunk <= W) {
        const int4* p = reinterpret_cast<const int4*>(prow + base);
        const int4 a = __ldg(p), b = __ldg(p + 1);
        w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
        w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else {
#pragma unroll
        for (int i = 0; i < kWordsPerChunk; ++i)
            w[i] = base + i < W ? (unsigned)__ldg(prow + base + i) : 0u;
    }
}

__device__ __forceinline__ void zero(unsigned (&w)[8]) {
#pragma unroll
    for (int i = 0; i < kWordsPerChunk; ++i) w[i] = 0u;
}

__device__ __forceinline__ int popc8(const unsigned (&w)[8]) {
    int c = 0;
#pragma unroll
    for (int i = 0; i < kWordsPerChunk; ++i) c += __popc(w[i]);
    return c;
}

// Write the row ranks [lo, hi) that fall in one group: the lane's chunk
// words w, ex the rank of the chunk's first set bit, col0 the group's first
// column. Warp-uniform call (lo < hi).
__device__ __forceinline__ void emit_group(const unsigned (&w)[8], int ex,
                                           int lo, int hi, int col0,
                                           int* irow, unsigned* sw, int* sp,
                                           int lane) {
    int p = ex;
#pragma unroll
    for (int i = 0; i < kWordsPerChunk; ++i) {
        sw[lane * kWordsPerChunk + i] = w[i];
        sp[lane * kWordsPerChunk + i] = p;
        p += __popc(w[i]);
    }
    __syncwarp();
    for (int t = lo + lane; t < hi; t += 32) {
        // the last word whose first rank is <= t holds rank t (sp[0] == lo)
        int i = 0;
#pragma unroll
        for (int s = kGroupWords / 2; s > 0; s >>= 1)
            if (sp[i + s] <= t) i += s;
        irow[t] = col0 + i * 32 + select_bit(sw[i], t - sp[i]);
    }
    __syncwarp();
}

// This lane's share of the chunk counts crow[c0, end): 8 loads in flight.
__device__ __forceinline__ int sum_counts(const int* crow, int c0, int end,
                                          int lane) {
    int s = 0;
    for (int c = c0 + lane; c < end; c += 32 * 8) {
        int v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            v[j] = c + 32 * j < end ? __ldg(crow + c + 32 * j) : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) s += v[j];
    }
    return s;
}

// Exclusive scan of the warps' span sums within each row of the block:
// before = the row's matches in the spans ahead of this warp's, total = the
// row's. Every thread of the block calls it once.
__device__ __forceinline__ void span_scan(int s, int warp, int lane, int S,
                                          int* s_sum, int& before,
                                          int& total) {
    if (lane == 0) s_sum[warp] = s;
    __syncthreads();
    const int first = warp - warp % S;
    before = 0;
    total = 0;
    for (int i = first; i < first + S; ++i) {
        const int v = s_sum[i];
        if (i < warp) before += v;
        total += v;
    }
}

// 4 blocks an SM (at most 64 registers a thread): the main path's 4096-row
// launches fit the card in one wave of 32 warps an SM; with the 75-78
// registers ptxas picks unbounded, 3 blocks fit and a second wave costs
// 15-25% more than the few bytes this spills.
template <bool kCounts>
__global__ void __launch_bounds__(kThreads, 4)
extract_kernel(const int* __restrict__ packed, const int* __restrict__ counts,
               const int* __restrict__ rows,
               const unsigned char* __restrict__ ok, int* __restrict__ idx,
               unsigned char* __restrict__ valid, int* __restrict__ cnt,
               int R, int R0, int W, int nb, int k, int S, int gp, int vec) {
    __shared__ unsigned s_words[kWarps][kGroupWords];
    __shared__ int s_rank[kWarps][kGroupWords];
    __shared__ int s_sum[kWarps];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int part = warp % S;
    const int r = blockIdx.x * (kWarps / S) + warp / S;
    const bool in = r < R;
    const bool live = in && (ok == nullptr || ok[r]);
    int src = in ? (rows != nullptr ? rows[r] : r) : 0;
    src = src < 0 ? 0 : (src >= R0 ? R0 - 1 : src);
    const int* prow = packed + (size_t)src * W;
    int* irow = idx + (size_t)r * k;
    const int ngroups = (nb + 31) / 32;
    const int g_lo = min(ngroups, part * gp);
    const int g_hi = min(ngroups, g_lo + gp);
    unsigned* sw = s_words[warp];
    int* sp = s_rank[warp];
    int count;

    if (kCounts) {
        const int* crow = counts + (size_t)src * nb;
        const int end = min(nb, g_hi * 32);
        int run = 0;
        if (S > 1) {   // a split row: the spans' sums first
            const int s = live ? sum_counts(crow, g_lo * 32, end, lane) : 0;
            span_scan(warp_sum(s), warp, lane, S, s_sum, run, count);
        }
        // only the chunks that hold one of the first k matches load words
        int gs = g_lo;
        for (; live && gs < g_hi && run < k; gs += kG) {
            int c[kG], ex[kG], lo[kG];
#pragma unroll
            for (int g = 0; g < kG; ++g) {
                const int ch = (gs + g) * 32 + lane;
                c[g] = gs + g < g_hi && ch < nb ? __ldg(crow + ch) : 0;
            }
#pragma unroll
            for (int g = 0; g < kG; ++g) {
                const int incl = warp_inclusive_sum(c[g], lane);
                lo[g] = run;
                ex[g] = run + incl - c[g];
                run += __shfl_sync(0xffffffffu, incl, 31);
            }
            unsigned w[kG][8];
#pragma unroll
            for (int g = 0; g < kG; ++g) {
                if (c[g] > 0 && ex[g] < k)
                    load_chunk(prow, (gs + g) * 32 + lane, W, vec, w[g]);
                else
                    zero(w[g]);
            }
#pragma unroll
            for (int g = 0; g < kG; ++g) {
                const int hi = min(k, g + 1 < kG ? lo[g + 1] : run);
                if (lo[g] < hi)
                    emit_group(w[g], ex[g], lo[g], hi, (gs + g) * kGroupCols,
                               irow, sw, sp, lane);
            }
        }
        if (S == 1) {  // one warp a row: past the first k, a sum is left
            const int rest = live ? sum_counts(crow, min(gs, g_hi) * 32,
                                               end, lane) : 0;
            count = run + warp_sum(rest);
        }
    } else if (S == 1) {
        // one warp a row: stream its groups, count and emit in one pass
        int run = 0;
        for (int gs = g_lo; live && gs < g_hi; gs += kG) {
            unsigned w[kG][8];
#pragma unroll
            for (int g = 0; g < kG; ++g) {
                const int ch = (gs + g) * 32 + lane;
                if (gs + g < g_hi && ch < nb)
                    load_chunk(prow, ch, W, vec, w[g]);
                else
                    zero(w[g]);
            }
            int ex[kG], lo[kG];
#pragma unroll
            for (int g = 0; g < kG; ++g) {
                const int c = popc8(w[g]);
                const int incl = warp_inclusive_sum(c, lane);
                lo[g] = run;
                ex[g] = run + incl - c;
                run += __shfl_sync(0xffffffffu, incl, 31);
            }
            if (lo[0] < k) {
#pragma unroll
                for (int g = 0; g < kG; ++g) {
                    const int hi = min(k, g + 1 < kG ? lo[g + 1] : run);
                    if (lo[g] < hi)
                        emit_group(w[g], ex[g], lo[g], hi,
                                   (gs + g) * kGroupCols, irow, sw, sp, lane);
                }
            }
        }
        count = run;
    } else {
        // a split row: the span (at most kG groups) stays in registers
        // while the spans' totals are scanned
        unsigned w[kG][8];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
            const int ch = (g_lo + g) * 32 + lane;
            if (live && g_lo + g < g_hi && ch < nb)
                load_chunk(prow, ch, W, vec, w[g]);
            else
                zero(w[g]);
        }
        int ex[kG], lo[kG];
        int run = 0;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
            const int c = popc8(w[g]);
            const int incl = warp_inclusive_sum(c, lane);
            lo[g] = run;
            ex[g] = run + incl - c;
            run += __shfl_sync(0xffffffffu, incl, 31);
        }
        int before;
        span_scan(run, warp, lane, S, s_sum, before, count);
        if (before < k) {
#pragma unroll
            for (int g = 0; g < kG; ++g) {
                const int a = before + lo[g];
                const int hi = min(k, before + (g + 1 < kG ? lo[g + 1] : run));
                if (a < hi)
                    emit_group(w[g], before + ex[g], a, hi,
                               (g_lo + g) * kGroupCols, irow, sw, sp, lane);
            }
        }
    }

    if (in) {
        unsigned char* vrow = valid + (size_t)r * k;
        for (int j = part * 32 + lane; j < k; j += S * 32) {
            vrow[j] = j < count;
            if (j >= count) irow[j] = 0;
        }
        if (part == 0 && lane == 0) cnt[r] = count;
    }
}

}  // namespace

// S warps a row (1, 2, 4 or 8); counts may be null (then nb = ceil(W / 8)),
// rows and ok may be null. Returns the launch's CUDA error code.
extern "C" int extract_launch(const void* packed, const void* counts,
                              const void* rows, const void* ok, void* idx,
                              void* valid, void* cnt, int R, int R0, int W,
                              int nb, int k, int S, void* stream) {
    const int ngroups = (nb + 31) / 32;
    if (R <= 0 || R0 <= 0 || W <= 0 || k <= 0
        || (S != 1 && S != 2 && S != 4 && S != 8)
        || (counts != nullptr ? W != nb * kWordsPerChunk
                              : nb != (W + kWordsPerChunk - 1)
                                          / kWordsPerChunk))
        return (int)cudaErrorInvalidValue;
    const int gp = (ngroups + S - 1) / S;
    if (counts == nullptr && S > 1 && gp > kG)
        return (int)cudaErrorInvalidValue;   // a split span must fit
    const long long blocks = ((long long)R * S + kWarps - 1) / kWarps;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    const int vec = W % 4 == 0
        && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
    auto s = static_cast<cudaStream_t>(stream);
    const auto* p = static_cast<const int*>(packed);
    const auto* c = static_cast<const int*>(counts);
    const auto* rw = static_cast<const int*>(rows);
    const auto* o = static_cast<const unsigned char*>(ok);
    auto* ix = static_cast<int*>(idx);
    auto* v = static_cast<unsigned char*>(valid);
    auto* n = static_cast<int*>(cnt);
    if (counts != nullptr)
        extract_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
            p, c, rw, o, ix, v, n, R, R0, W, nb, k, S, gp, vec);
    else
        extract_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
            p, c, rw, o, ix, v, n, R, R0, W, nb, k, S, gp, vec);
    return (int)cudaGetLastError();
}
