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
// the layout of match_kernel._pack_mask). One kernel serves both phases: the
// probe's 32-query tiles against their bucket windows, and the dense phase's
// tiles of 32 wildcard-first queries against a window of the whole table.
//
// What bounds it. Integer compares on the CUDA cores: (lc + 3) per (query,
// row) pair at the least, against the rows' lc words and meta (4·lc + 4
// bytes per distinct row) and the packed mask (one bit per pair). At the
// retained storm of 1M topics (lc = 3) the probe does ~7e7 pairs and the
// dense phase ~2.7e8: a few tens of microseconds either way, the dense
// phase bound by operations. As built, each pair costs a handful of
// instructions plus a ballot; no boolean intermediate reaches device memory.
//
// Design (simple first, made fast in later work).
// - Blocks: grid (seg / 256 row chunks, T tiles, TP / 32 query groups);
//   256 threads. A block stages its 32 queries (selector, eff, flags, lc
//   words and a care mask: bit l set iff level l must be equal) and its 256
//   window rows (lc words, level-major, and meta) in shared memory with
//   coalesced loads.
// - Compare: warp w owns rows 32w..32w+31 of the chunk, one per lane, its
//   lc words in registers; it walks the 32 queries (read from shared memory
//   as broadcasts), and __ballot_sync packs the 32 verdicts of a query into
//   its word. Lane i keeps query i's word.
// - Store: the 32 x 8 words go through shared memory and leave as 8
//   consecutive words (one 32-byte sector) per query row.
// - Bounds: the wrapper checks start + seg <= N on the host starts; rows
//   past N still read as inactive here and selectors are clamped into the
//   query block, so a bad argument cannot read outside its arrays.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;            // window rows per block
constexpr int kWarps = kRows / 32;    // one 32-row word per warp
constexpr int kQueries = 32;          // queries per block
constexpr int kPlus = 1;              // PLUS_ID
constexpr int kMaxLc = 32;            // care masks are 32-bit

template <int LCMAX>
__global__ void __launch_bounds__(kRows)
reverse_match_kernel(const int* __restrict__ row_words,
                     const int* __restrict__ meta,
                     const int* __restrict__ q_words,
                     const int* __restrict__ q_eff,
                     const int* __restrict__ q_flags,
                     const int* __restrict__ sel,
                     const int* __restrict__ start,
                     int* __restrict__ out,
                     int TP, int L, int N, int B, int seg, int lc) {
    __shared__ int s_rows[LCMAX][kRows];
    __shared__ int s_meta[kRows];
    __shared__ int s_qw[LCMAX][kQueries];
    __shared__ int s_sel[kQueries];
    __shared__ int s_eff[kQueries];
    __shared__ int s_flags[kQueries];
    __shared__ unsigned s_care[kQueries];
    __shared__ int s_out[kQueries][kWarps];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int chunk = blockIdx.x;
    const int t = blockIdx.y;
    const int q0 = blockIdx.z * kQueries;
    const long long row0 = (long long)start[t] + (long long)chunk * kRows;

    // queries: selector, eff, flags
    if (tid < kQueries) {
        int s = sel[(size_t)t * TP + q0 + tid];
        s = s < 0 ? 0 : (s >= B ? B - 1 : s);
        s_sel[tid] = s;
        s_eff[tid] = q_eff[s];
        s_flags[tid] = q_flags[s];
    }
    // rows: lc words (level-major in shared memory) and meta
    for (int e = tid; e < kRows * lc; e += kRows) {
        const int r = e / lc, l = e - r * lc;
        const long long row = row0 + r;
        s_rows[l][r] = (row >= 0 && row < N)
            ? row_words[(size_t)row * L + l] : 0;
    }
    {
        const long long row = row0 + tid;
        s_meta[tid] = (row >= 0 && row < N) ? meta[row] : 0;
    }
    __syncthreads();
    for (int e = tid; e < kQueries * lc; e += kRows) {
        const int i = e / lc, l = e - i * lc;
        s_qw[l][i] = q_words[(size_t)s_sel[i] * L + l];
    }
    __syncthreads();
    if (tid < kQueries) {
        const int eff = s_eff[tid];
        unsigned care = 0;
        for (int l = 0; l < lc; ++l)
            care |= (unsigned)(l < eff && s_qw[l][tid] != kPlus) << l;
        s_care[tid] = care;
    }
    __syncthreads();

    // this lane's row
    const int r = warp * 32 + lane;
    const int m = s_meta[r];
    const int rlen = m & 0xFFFF;
    const bool rdollar = (m >> 16) & 1;
    const bool ractive = (m >> 17) & 1;
    int rw[LCMAX];
#pragma unroll
    for (int l = 0; l < LCMAX; ++l) rw[l] = l < lc ? s_rows[l][r] : 0;

    int mine = 0;
    for (int i = 0; i < kQueries; ++i) {
        const int eff = s_eff[i];
        const int f = s_flags[i];
        const unsigned care = s_care[i];
        bool ok = ractive && ((f & 1) ? rlen >= eff : rlen == eff)
                  && !(rdollar && (f & 2));
        unsigned miss = 0;
#pragma unroll
        for (int l = 0; l < LCMAX; ++l)
            miss |= (unsigned)(s_qw[l][i] != rw[l]) << l;
        ok = ok && (miss & care) == 0;
        const unsigned word = __ballot_sync(0xffffffffu, ok);
        if (lane == i) mine = (int)word;
    }
    s_out[lane][warp] = mine;
    __syncthreads();

    // 8 consecutive words (one sector) per query row
    const int i = tid / kWarps, w = tid % kWarps;
    const int W = seg / 32;
    out[((size_t)t * TP + q0 + i) * W + (size_t)chunk * kWarps + w] =
        s_out[i][w];
}

template <int LCMAX>
int launch(const void* row_words, const void* meta, const void* q_words,
           const void* q_eff, const void* q_flags, const void* sel,
           const void* start, void* out, int T, int TP, int L, int N, int B,
           int seg, int lc, cudaStream_t stream) {
    dim3 grid(seg / kRows, T, TP / kQueries);
    reverse_match_kernel<LCMAX><<<grid, kRows, 0, stream>>>(
        static_cast<const int*>(row_words), static_cast<const int*>(meta),
        static_cast<const int*>(q_words), static_cast<const int*>(q_eff),
        static_cast<const int*>(q_flags), static_cast<const int*>(sel),
        static_cast<const int*>(start), static_cast<int*>(out), TP, L, N, B,
        seg, lc);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int reverse_match_launch(const void* row_words, const void* meta,
                                    const void* q_words, const void* q_eff,
                                    const void* q_flags, const void* sel,
                                    const void* start, void* out, int T,
                                    int TP, int L, int N, int B, int seg,
                                    int lc, void* stream) {
    if (T <= 0 || T > 65535 || TP <= 0 || TP % kQueries
        || TP / kQueries > 65535 || B <= 0 || seg <= 0 || seg % kRows
        || lc < 1 || lc > L || lc > kMaxLc)
        return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    if (lc <= 4)
        return launch<4>(row_words, meta, q_words, q_eff, q_flags, sel,
                         start, out, T, TP, L, N, B, seg, lc, s);
    if (lc <= 8)
        return launch<8>(row_words, meta, q_words, q_eff, q_flags, sel,
                         start, out, T, TP, L, N, B, seg, lc, s);
    if (lc <= 16)
        return launch<16>(row_words, meta, q_words, q_eff, q_flags, sel,
                          start, out, T, TP, L, N, B, seg, lc, s);
    return launch<32>(row_words, meta, q_words, q_eff, q_flags, sel, start,
                      out, T, TP, L, N, B, seg, lc, s);
}
