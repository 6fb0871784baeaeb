// Reverse-compare tile matcher for Hopper (sm_90a): retained topics against
// subscription filters.
//
// Replaces the mask phases of vernemq_tpu/ops/reverse_kernel.py:reverse_match
// (the probe tiles _tile_masks and the dense _dense_compare / _dense_coded),
// which XLA fuses with the bit-pack (_pack_mask). For tile t (TP query slots
// sel[t, :] against seg contiguous table rows from start[t]), query
// q = sel[t, p] matches row r = start[t] + j iff
//
//   has_hash[q] ? row_len[r] >= eff[q] : row_len[r] == eff[q]
//   !(row_dollar[r] && first_wild[q])          (MQTT-4.7.2-1)
//   row_active[r]
//   for l < lc: words[q][l] == row[r][l] || words[q][l] == PLUS || l >= eff[q]
//
// and out[t * TP + p][j / 32] holds that verdict in bit j % 32 (int32 words:
// the layout of match_kernel._pack_mask). A slot whose selector is negative
// is empty: its row is 0. Beside the words, counts[t * TP + p][j / 256]
// holds the number of set bits in each 256-row chunk (the block counts of a
// two-level extraction). One kernel serves both phases: the probe's tiles
// against their bucket windows, and the dense phase's tile of up to 256
// wildcard-first queries against a window of the whole table.
//
// What bounds it. Integer operations on the CUDA cores: the rule needs
// lc + 3 compares per (query, row) pair, against 4·lc + 4 bytes per distinct
// row and one bit per pair written. At the retained storm of 1M topics
// (lc = 3) the dense phase is ~2.2e8 pairs and the probe ~4e7: the INT32
// lanes (64 per SM per clock) bound both, the bytes take a fifth to a third
// of that time. So the design counts instructions per pair.
//
// Design.
// - Lane = query. A block is one tile of TP <= 256 slots, one thread per
//   slot, over a span of up to 1024 window rows (grid: spans x tiles). Each
//   thread keeps its query in registers: its lc words, a care mask per level
//   (all ones iff level < eff and the word is not '+'), and a length window.
//   A warp whose 32 slots are all empty skips the compare.
// - Rows stream once per block: 256-row chunks staged in shared memory with
//   coalesced 16-byte loads (the row's levels, 4 per load). Staging turns
//   the meta word into two length words, P = len | flag << 20, with the flag
//   "inactive" for ordinary queries and "inactive or $" for wildcard-first
//   ones; a lane reads the one its query needs (two addresses per warp: no
//   bank conflict). Words are read as warp-wide broadcasts.
// - A pair is one test: acc = ((P - lo) & lm) | OR_l ((row_l ^ q_l) & care_l)
//   is 0 iff the pair matches. lo = eff; lm = 0xFFFF0000 with '#' (P - lo
//   has a high bit iff len < eff or a flag is set), all ones without (P ==
//   eff). Levels are unrolled to exactly lc (templates for lc 1..8, then 12,
//   16, 24, 32 with the levels past lc masked off). At lc = 3 the sm_90a
//   code per pair is three 3-input LOPs for the levels, two more that merge
//   and test (the last one sets the predicate), an IMAD for the subtract, a
//   SEL and half a LOP to put the bit into the lane's word, and a quarter of
//   a 16-byte shared load for the length words: ~9 instructions.
// - Each lane ORs its verdicts into its own word (32 rows), counts the word
//   into its chunk count, and parks both in shared memory; the span leaves
//   as 128-byte rows of words per slot and 16-byte rows of counts, which
//   the extraction kernel (csrc/extract.cu) reads as its chunk counts.
// - Bounds: the wrapper checks start + seg <= N on the host starts; rows
//   past N still read as inactive here and selectors >= B are clamped into
//   the query block, so a bad argument cannot read outside its arrays.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;                  // rows per staged chunk / count
constexpr int kSpan = 1024;                  // rows per block
constexpr int kSpanWords = kSpan / 32;
constexpr int kSpanChunks = kSpan / kChunk;
constexpr int kOutStride = kSpanWords + 1;   // padded: no bank conflicts
constexpr int kMaxTile = 256;
constexpr int kPlus = 1;                     // PLUS_ID
constexpr int kMaxLc = 32;
constexpr unsigned kFlag = 1u << 20;         // above any 16-bit length

__host__ __device__ constexpr int vecs(int lc) { return (lc + 3) / 4; }

__host__ __device__ constexpr size_t smem_bytes(int lc, int tp) {
    return (size_t)kChunk * vecs(lc) * 16 + 2u * kChunk * 4
           + (size_t)tp * kOutStride * 4 + (size_t)tp * kSpanChunks * 4;
}

__device__ __forceinline__ unsigned lane_term(int row, int q, unsigned care) {
    return ((unsigned)row ^ (unsigned)q) & care;
}

template <int LC>
__global__ void __launch_bounds__(kMaxTile)
reverse_match_kernel(const int* __restrict__ row_words,
                     const int* __restrict__ meta,
                     const int* __restrict__ q_words,
                     const int* __restrict__ q_eff,
                     const int* __restrict__ q_flags,
                     const int* __restrict__ sel,
                     const int* __restrict__ start,
                     int* __restrict__ out,
                     int* __restrict__ counts,
                     int TP, int L, int N, int B, int seg, int lc, int vec) {
    constexpr int V = vecs(LC);
    extern __shared__ int4 smem[];
    int4* s_rows = smem;                                       // [kChunk][V]
    unsigned* s_p = reinterpret_cast<unsigned*>(s_rows + kChunk * V);
    unsigned* s_out = s_p + 2 * kChunk;                        // [TP][33]
    int* s_cnt = reinterpret_cast<int*>(s_out + TP * kOutStride);  // [TP][4]

    const int tid = threadIdx.x;
    const int t = blockIdx.y;
    const int span0 = blockIdx.x * kSpan;              // window offset
    const int nchunk = min(kSpan, seg - span0) / kChunk;
    const long long row0 = (long long)start[t] + span0;

    // this thread's query: words, care masks and the length window
    int s = sel[(size_t)t * TP + tid];
    const bool live = s >= 0;
    s = s < 0 ? 0 : (s >= B ? B - 1 : s);
    const int eff = q_eff[s];
    const int f = q_flags[s];
    int qw[LC];
    unsigned qm[LC];
#pragma unroll
    for (int l = 0; l < LC; ++l) {
        const int w = l < lc ? q_words[(size_t)s * L + l] : 0;
        qw[l] = w;
        qm[l] = (l < lc && l < eff && w != kPlus) ? ~0u : 0u;
    }
    unsigned lo, lm;
    if (!live || eff > 0xFFFF || (eff < 0 && !(f & 1))) {
        lo = 0x7FFFFFFFu;                 // matches nothing: P < 2^22
        lm = ~0u;
    } else if (f & 1) {                   // '#': len in [eff, 0xFFFF]
        lo = eff < 0 ? 0u : (unsigned)eff;
        lm = 0xFFFF0000u;
    } else {                              // len == eff
        lo = (unsigned)eff;
        lm = ~0u;
    }
    const unsigned* s_pq = s_p + ((f & 2) ? kChunk : 0);
    const bool warp_live = __any_sync(0xffffffffu, live);
    const bool block_live = __syncthreads_or(live);

    for (int c = 0; c < nchunk; ++c) {
        if (!block_live) {
            if (c == 0) {
                for (int i = tid; i < TP * kOutStride; i += TP) s_out[i] = 0u;
                for (int i = tid; i < TP * kSpanChunks; i += TP) s_cnt[i] = 0;
            }
            continue;
        }
        __syncthreads();   // the previous chunk's compare is done with s_rows
        const long long r0 = row0 + (long long)c * kChunk;
        for (int i = tid; i < kChunk * V; i += TP) {
            const int r = i / V, v = i - r * V;
            const long long row = r0 + r;
            int4 x = make_int4(0, 0, 0, 0);
            if (row >= 0 && row < N && 4 * v < lc) {   // lc <= L
                const int* src = row_words + (size_t)row * L + 4 * v;
                if (vec && 4 * v + 3 < L) {
                    x = __ldg(reinterpret_cast<const int4*>(src));
                } else {
                    const int n = L - 4 * v;
                    x.x = __ldg(src);
                    if (n > 1) x.y = __ldg(src + 1);
                    if (n > 2) x.z = __ldg(src + 2);
                    if (n > 3) x.w = __ldg(src + 3);
                }
            }
            s_rows[i] = x;
        }
        for (int i = tid; i < kChunk; i += TP) {
            const long long row = r0 + i;
            const unsigned m = (row >= 0 && row < N) ? (unsigned)__ldg(meta + row)
                                                     : 0u;
            const unsigned len = m & 0xFFFFu;
            const unsigned inactive = ((m >> 17) & 1u) ^ 1u;
            const unsigned dollar = (m >> 16) & 1u;
            s_p[i] = len | (inactive ? kFlag : 0u);
            s_p[kChunk + i] = len | ((inactive | dollar) ? kFlag : 0u);
        }
        __syncthreads();

        int cnt = 0;
        if (warp_live) {
#pragma unroll 1
            for (int w = 0; w < kChunk / 32; ++w) {
                unsigned word = 0;
#pragma unroll
                for (int b = 0; b < 32; ++b) {
                    const int j = w * 32 + b;
                    const int4* rv = s_rows + j * V;
                    unsigned acc = (s_pq[j] - lo) & lm;
#pragma unroll
                    for (int v = 0; v < V; ++v) {
                        const int4 x = rv[v];
                        if (4 * v + 0 < LC) acc |= lane_term(x.x, qw[4 * v + 0], qm[4 * v + 0]);
                        if (4 * v + 1 < LC) acc |= lane_term(x.y, qw[4 * v + 1], qm[4 * v + 1]);
                        if (4 * v + 2 < LC) acc |= lane_term(x.z, qw[4 * v + 2], qm[4 * v + 2]);
                        if (4 * v + 3 < LC) acc |= lane_term(x.w, qw[4 * v + 3], qm[4 * v + 3]);
                    }
                    word |= (acc == 0u ? 1u : 0u) << b;
                }
                s_out[tid * kOutStride + c * (kChunk / 32) + w] = word;
                cnt += __popc(word);
            }
        } else {
#pragma unroll
            for (int w = 0; w < kChunk / 32; ++w)
                s_out[tid * kOutStride + c * (kChunk / 32) + w] = 0u;
        }
        s_cnt[tid * kSpanChunks + c] = cnt;
    }
    __syncthreads();

    // the span's words (one row of up to 32 words per slot) and counts
    const int W = seg / 32;
    const int nb = seg / kChunk;
    const int nw = nchunk * (kChunk / 32);
    const size_t slot0 = (size_t)t * TP;
    for (int i = tid; i < TP * nw; i += TP) {
        const int p = i / nw, w = i - p * nw;
        out[(slot0 + p) * W + span0 / 32 + w] = (int)s_out[p * kOutStride + w];
    }
    for (int i = tid; i < TP * nchunk; i += TP) {
        const int p = i / nchunk, c = i - p * nchunk;
        counts[(slot0 + p) * nb + span0 / kChunk + c] =
            s_cnt[p * kSpanChunks + c];
    }
}

template <int LC>
int launch(const void* row_words, const void* meta, const void* q_words,
           const void* q_eff, const void* q_flags, const void* sel,
           const void* start, void* out, void* counts, int T, int TP, int L,
           int N, int B, int seg, int lc, cudaStream_t stream) {
    const size_t smem = smem_bytes(LC, TP);
    static bool opted_in = false;  // once per template: raise the 48 KB cap
    if (!opted_in) {
        const cudaError_t e = cudaFuncSetAttribute(
            reverse_match_kernel<LC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes(LC, kMaxTile));
        if (e != cudaSuccess) return (int)e;
        opted_in = true;
    }
    const int vec = (L % 4 == 0)
        && (reinterpret_cast<uintptr_t>(row_words) % 16 == 0);
    dim3 grid((seg + kSpan - 1) / kSpan, T);
    reverse_match_kernel<LC><<<grid, TP, smem, stream>>>(
        static_cast<const int*>(row_words), static_cast<const int*>(meta),
        static_cast<const int*>(q_words), static_cast<const int*>(q_eff),
        static_cast<const int*>(q_flags), static_cast<const int*>(sel),
        static_cast<const int*>(start), static_cast<int*>(out),
        static_cast<int*>(counts), TP, L, N, B, seg, lc, vec);
    return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one compare block: the lc template's staged
// rows, their length words, and the words and counts of TP slots.
extern "C" int reverse_match_smem_bytes(int lc, int tp) {
    const int t = lc <= 8 ? lc : lc <= 12 ? 12 : lc <= 16 ? 16
        : lc <= 24 ? 24 : 32;
    return (int)smem_bytes(t, tp);
}

extern "C" int reverse_match_launch(const void* row_words, const void* meta,
                                    const void* q_words, const void* q_eff,
                                    const void* q_flags, const void* sel,
                                    const void* start, void* out,
                                    void* counts, int T, int TP, int L,
                                    int N, int B, int seg, int lc,
                                    void* stream) {
    if (T <= 0 || T > 65535 || TP <= 0 || TP % 32 || TP > kMaxTile
        || B <= 0 || seg <= 0 || seg % kChunk || lc < 1 || lc > L
        || lc > kMaxLc)
        return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
#define REVERSE_LAUNCH(LCT)                                                   \
    return launch<LCT>(row_words, meta, q_words, q_eff, q_flags, sel, start, \
                       out, counts, T, TP, L, N, B, seg, lc, s)
    switch (lc) {
        case 1: REVERSE_LAUNCH(1);
        case 2: REVERSE_LAUNCH(2);
        case 3: REVERSE_LAUNCH(3);
        case 4: REVERSE_LAUNCH(4);
        case 5: REVERSE_LAUNCH(5);
        case 6: REVERSE_LAUNCH(6);
        case 7: REVERSE_LAUNCH(7);
        case 8: REVERSE_LAUNCH(8);
        default: break;
    }
    if (lc <= 12) REVERSE_LAUNCH(12);
    if (lc <= 16) REVERSE_LAUNCH(16);
    if (lc <= 24) REVERSE_LAUNCH(24);
    REVERSE_LAUNCH(32);
#undef REVERSE_LAUNCH
}
