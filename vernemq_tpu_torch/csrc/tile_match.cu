// Probe-window tile matcher for Hopper (sm_90a), on the tensor cores.
//
// Replaces vernemq_tpu/ops/pallas_match.py:window_tiles_packed (the Pallas
// body _tile_kernel) and the XLA form match_kernel.py:_window_tiles_sel.
// For tile t (TP publishes against seg_max contiguous table rows starting at
// start[t]) and window row j, publish p matches row r = start[t] + j iff
//
//   G[t,p,:] . F_t[:,r] + t1[r] == 0        (every concrete level matches)
//   has_hash[r] ? plen[p] >= eff[r] : plen[p] == eff[r]
//   !(pd[p] && first_wild[r])               ($-topics skip root wildcards)
//   active[r] and the row mode's guard:
//     probe A (mode 0)   r >= glob_pad && !first_wild[r]
//     probe B (mode 1)   r >= glob_pad &&  first_wild[r]
//     dense   (mode 2)   r <  glob_pad   (region 0, every row of it)
//     shard   (mode 3)   r >= glob_pad   (no first-level split)
//
// and out[t, p, j / 32] holds that verdict in bit j % 32 (int32 words).
// The dense mode is the forward path's dense region 0 (the reference's
// vernemq_tpu/ops/match_kernel.py:_dense_region0, fused by XLA): tiles of
// consecutive publishes, every window starting at row 0. The shard mode is
// a mesh shard's probe A (vernemq_tpu/parallel/sharded_match.py:278, which
// keeps a row by its global index alone): there glob_pad is the signed
// threshold glob_pad - row_base of the shard's own rows, so it may be
// negative, and a threshold <= 0 keeps every row (the guard off, for the
// per-slice match of vernemq_tpu/parallel/mesh_match.py:338).
//
// What bounds it. At the headline (1M subscriptions, K = 40, T = 24 tiles of
// TP = 256 publishes, seg_max = 262,144) a tile does 2·40 = 80 FLOP per
// (publish, row) pair on 80 bytes of F_t per row shared by 256 publishes:
// the function is bound by operations (1.3e11 FLOP per probe A), far above
// the memory roofline, and only the tensor cores (989 TFLOP/s dense bf16)
// come near that bound; the CUDA cores' fp32 rate (67 TFLOP/s) does not.
// Next come the per-pair epilogue (1.6e9 pairs in probe A) and the 201 MB of
// packed mask probe A writes. As built here the kernel runs at about a
// quarter of the dense bf16 rate on the padded product (chip_smoke.py, one
// H100 80GB HBM3 at 700 W: PERF.md). It is probably held by the issue rate
// and latency of mma.sync with its dependent epilogue; that is inferred from
// timings without a profiler, not measured. wgmma fed by TMA is the next
// step.
//
// Design.
// - Product: mma.sync.m16n8k16 (bf16 operands, fp32 accumulator) with
//   publishes on M and window rows on N. K grows by kT1Cols = 3 columns that
//   carry t1[r] - 1 into the product (F rows (t & 255) - 1, (t >> 8 & 255)
//   << 8 and (t >> 16) << 16 of t = t1[r], each bf16-exact, against G = 1)
//   and is padded with zeros to KP, a multiple of 16 (40 + 3 -> 48). So the
//   accumulator starts at zero (no per-tile initialisation) and ends at
//   mismatch - 1: the mismatch is a weighted sum of squares, >= 0, so it is
//   0 exactly when the result is negative.
// - Blocks: grid (T, chunk groups). A block stages its tile's G (TP x KP,
//   rows padded to an odd number of 16-byte units so ldmatrix is free of
//   bank conflicts) once, then walks kChunksPerBlock chunks of kChunk = 256
//   window rows. Each of the 8 warps owns one 32-row word of a chunk: it
//   keeps its rows' B fragments (KP/2 registers) in registers and loops
//   over the TP/16 publish tiles, loading each A fragment with ldmatrix.x4.
// - Loads: each chunk's F_t columns, t1, eff and flags go through a ring of
//   two shared-memory stages with cp.async (16-byte pieces, zero-filled past
//   S), the next chunk in flight while this one computes. Windows may start
//   on any row: a stage holds the chunk from the 8-row-aligned row below its
//   start (kChunkPad = 264 columns), and the B fragments are read with
//   16-bit shared loads at the start's offset (once per chunk; they are
//   reused by all TP/16 publish tiles, so ldmatrix alignment buys nothing
//   there). Each warp writes the t1 rows of its own 32 columns after the
//   chunk lands. Needs S % 8 == 0 (16-byte rows), which the wrapper checks.
// - Epilogue: in an m16n8 accumulator lane l holds rows 2(l%4), 2(l%4)+1 of
//   publishes l/4 and l/4 + 8. The verdict is the accumulator's sign bit:
//   byte permutes (prmt, sign-replicating) gather the four n-tiles' signs
//   into bytes of 0x00/0xFF, one AND picks bit 2(l%4) (+1) of each byte, and
//   two xor-shuffles (1, 2) OR the quad into whole 32-bit words, bit j = row
//   j: about two integer operations per (publish, row) pair of a lane.
//   Every per-row condition (length rule, $ rule, liveness, the row mode's
//   guard) is folded into one 64-bit row mask indexed by the publish
//   key min(plen, 31) + 32·(pd > 0); the warp transposes its 32 rows' masks
//   (a 5-step shuffle transpose) into a 64-word table in shared memory, word
//   k = the rows whose mask has bit k, and a publish's word is (sign bits) &
//   table[key]: one lookup per publish and word. Clamping plen at 31 is
//   exact while eff <= 30; the table's eff is at most L <= 19 (MAX_K = 96).
// - Output: the verdict words of a chunk gather in shared memory as
//   [TP][8] and leave as 16-byte streaming stores, each publish's 32-byte
//   run of the chunk in two neighbouring lanes.
//
// Exactness. Every operand is bf16-exact: an integer of magnitude at most
// 2^16, or a piece of t1 (an integer in [0, 2^24)) with at most 8
// significant bits. So every product of two operands is an exact fp32
// integer. For
// K <= 96 (16 levels, 24-bit ids) the sum of |products| plus t1 + 1 stays
// below 1.3e7 < 2^24, so every partial sum, in any order and at any
// alignment the tensor core uses inside an mma, is an integer that fp32
// represents exactly: truncating or re-ordered accumulation cannot change an
// integer result, and "mismatch - 1 < 0" is exact, as "== 0" is on the
// TPU's MXU. The card tests check it bit for bit at the largest partial
// sums (every id 2^24 - 1 or 65535, K = 96).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = kWarps * 32;     // window rows per chunk: a word per warp
constexpr int kWords = kChunk / 32;     // output words per publish per chunk
constexpr int kChunkPad = kChunk + 8;   // staged from the aligned row below
constexpr int kChunksPerBlock = 8;      // 2048 rows per block share one G load
// The dense mode's windows are short (region 0, 2048 rows at the headline)
// and its tiles many and small: one chunk a block, so the chunks of a tile
// run side by side instead of one after another (its G is TP x KP, a few KB)
constexpr int kDenseChunksPerBlock = 1;
constexpr int kT1Cols = 3;              // K columns carrying t1 - 1
constexpr int kMaskWords = 65;          // a warp's key table; key 64: no bit
constexpr uint16_t kBf16One = 0x3F80;
constexpr int kProbeB = 1;              // row modes (probe A is 0)
constexpr int kDense = 2;
constexpr int kShard = 3;

template <int KP>
struct Layout {
    static constexpr int GS = KP + 8;   // G row stride: odd count of 16 B units
    static constexpr size_t kStageF = (size_t)KP * kChunkPad * 2;
    static constexpr size_t kStage = kStageF + 3 * (size_t)kChunkPad * 4;
    __host__ __device__ static size_t g_bytes(int TP) {
        return (size_t)TP * GS * 2;
    }
    __host__ __device__ static size_t stage0(int TP) {
        return g_bytes(TP) + (size_t)TP * 4 + (size_t)TP * kWords * 4
               + (size_t)kWarps * kMaskWords * 4;  // 16-byte multiples all
    }
    __host__ __device__ static size_t bytes(int TP) {
        return stage0(TP) + 2 * kStage;
    }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int n = ok ? 16 : 0;  // 0: fill the 16 bytes with zeros
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// A fragments of one 16-publish tile, all k-steps; `p` is this lane's
// ldmatrix row address in the tile (row lane % 16, column 8 * (lane / 16))
template <int NKS>
__device__ __forceinline__ void load_a(uint32_t (&a)[NKS][4],
                                       const uint16_t* p) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) ldmatrix_x4(a[ks], p + 16 * ks);
}

// d += A(16x16, row) . B(16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = A . B (the accumulator starts at zero)
__device__ __forceinline__ void mma_bf16_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// Byte permute: byte i of the result is byte c[4i..4i+2] of {b:a}, or that
// byte's sign bit replicated over 8 bits when c[4i+3] is set
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// Bytes 0x00 / 0xFF of the sign bits of four floats, in order
__device__ __forceinline__ uint32_t sign_bytes(float x0, float x1, float x2,
                                               float x3) {
    const uint32_t lo = prmt(__float_as_uint(x0), __float_as_uint(x1), 0x00FBu);
    const uint32_t hi = prmt(__float_as_uint(x2), __float_as_uint(x3), 0xFB00u);
    return prmt(lo, hi, 0x7610u);
}

// Lane i holds row i of a 32x32 bit matrix (bit c = element (i, c)); returns
// column `lane` (bit i = element (i, lane)). Each step swaps the off-diagonal
// blocks of size j between lanes i and i ^ j.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
    const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                               0x33333333u, 0x55555555u};
#pragma unroll
    for (int s = 0; s < 5; ++s) {
        const int j = 16 >> s;
        const uint32_t m = masks[s];
        const uint32_t y = __shfl_xor_sync(0xffffffffu, x, j);
        x = (lane & j) ? ((x & ~m) | ((y >> j) & m))
                       : ((x & m) | ((y & m) << j));
    }
    return x;
}

// Stage the chunk whose aligned first row is a0: F_t rows 0..K-1 and t1,
// eff, flags, kChunkPad columns each (zeros past S).
template <int KP>
__device__ __forceinline__ void load_chunk(
    unsigned char* stage, const uint16_t* __restrict__ F_t,
    const float* __restrict__ t1, const int32_t* __restrict__ eff,
    const int32_t* __restrict__ flags, int K, int S, int a0, int tid) {
    uint16_t* sF = reinterpret_cast<uint16_t*>(stage);
    constexpr int kPieces = kChunkPad / 8;  // 16-byte pieces of a bf16 row
    for (int i = tid; i < K * kPieces; i += kThreads) {
        const int k = i / kPieces;
        const int c = i - k * kPieces;
        const int col = a0 + 8 * c;
        const bool ok = col < S;  // S % 8 == 0: a piece is all in or all out
        cp_async16(sF + k * kChunkPad + 8 * c,
                   ok ? F_t + (size_t)k * S + col : F_t, ok);
    }
    unsigned char* s4 = stage + Layout<KP>::kStageF;
    constexpr int kPieces4 = kChunkPad / 4;  // 16-byte pieces of a 4-byte row
    for (int i = tid; i < 3 * kPieces4; i += kThreads) {
        const int a = i / kPieces4;
        const int c = i - a * kPieces4;
        const int col = a0 + 4 * c;
        const bool ok = col < S;
        const void* src = a == 0 ? static_cast<const void*>(t1)
                        : a == 1 ? static_cast<const void*>(eff)
                                 : static_cast<const void*>(flags);
        src = static_cast<const unsigned char*>(src) + (ok ? 4 * (size_t)col : 0);
        cp_async16(s4 + ((size_t)a * kChunkPad + 4 * c) * 4, src, ok);
    }
}

template <int KP>
__global__ void __launch_bounds__(kThreads, KP <= 48 ? 2 : 1)
tile_match_kernel(const uint16_t* __restrict__ F_t,   // [K, S] bf16 bits
                  const float* __restrict__ t1,       // [S]
                  const int32_t* __restrict__ eff,    // [S]
                  const int32_t* __restrict__ flags,  // [S]
                  const uint16_t* __restrict__ Gt,    // [T, TP, K] bf16 bits
                  const int32_t* __restrict__ plt,    // [T, TP]
                  const int32_t* __restrict__ pdt,    // [T, TP]
                  const int32_t* __restrict__ start,  // [T]
                  int32_t* __restrict__ out,          // [T, TP, seg_max/32]
                  int K, int S, int TP, int seg_max, int glob_pad,
                  int mode) {
    using Lay = Layout<KP>;
    constexpr int GS = Lay::GS;
    constexpr int NKS = KP / 16;  // k-steps of one mma
    extern __shared__ __align__(128) unsigned char smem[];
    uint16_t* sG = reinterpret_cast<uint16_t*>(smem);
    int32_t* sKey = reinterpret_cast<int32_t*>(smem + Lay::g_bytes(TP));
    uint32_t* sOut = reinterpret_cast<uint32_t*>(sKey + TP);
    uint32_t* sMask = sOut + TP * kWords;  // [kWarps][kMaskWords]
    unsigned char* stages = smem + Lay::stage0(TP);

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;  // mma group: publish (A/C row), row (B column)
    const int q = lane & 3;   // thread in group
    const int nchunks = seg_max / kChunk;
    const int per_block = mode == kDense ? kDenseChunksPerBlock
                                         : kChunksPerBlock;
    const int c_begin = blockIdx.y * per_block;
    const int c_end = min(nchunks, c_begin + per_block);
    if (c_begin >= c_end) return;
    // the wrapper guarantees 0 <= start[t] and start[t] + seg_max <= S
    const int st = start[t];
    const int sh = st & 7;      // chunk start's column in its stage
    const int base = st - sh;   // 16-byte aligned row (S % 8 == 0)

    load_chunk<KP>(stages + (c_begin & 1) * Lay::kStage, F_t, t1, eff, flags,
                   K, S, base + c_begin * kChunk, tid);
    cp_async_commit();

    // F_t rows K + kT1Cols..KP-1 stay zero in both stages (the loads never
    // write them; rows K..K+2 are the t1 pieces, written per chunk)
    const int kz = K + kT1Cols;
    for (int s = 0; s < 2; ++s) {
        uint16_t* sF = reinterpret_cast<uint16_t*>(stages + s * Lay::kStage);
        for (int i = tid; i < (KP - kz) * kChunkPad; i += kThreads)
            sF[kz * kChunkPad + i] = 0;
    }
    // the tile's G, then 1 in the t1 columns K..K+2, zeros to GS
    const uint16_t* g_src = Gt + (size_t)t * TP * K;
    auto g_pad = [&](int k) -> uint32_t { return k < kz ? kBf16One : 0u; };
    if ((K & 1) == 0) {
        uint32_t* sG2 = reinterpret_cast<uint32_t*>(sG);
        const uint32_t* g2 = reinterpret_cast<const uint32_t*>(g_src);
#pragma unroll 4
        for (int i = tid; i < TP * (GS / 2); i += kThreads) {
            const int p = i / (GS / 2);
            const int k = 2 * (i - p * (GS / 2));
            sG2[i] = k < K ? g2[(size_t)p * (K / 2) + k / 2]
                           : g_pad(k) | g_pad(k + 1) << 16;
        }
    } else {
        for (int i = tid; i < TP * GS; i += kThreads) {
            const int p = i / GS;
            const int k = i - p * GS;
            sG[i] = k < K ? g_src[(size_t)p * K + k] : (uint16_t)g_pad(k);
        }
    }
    // publish key: bit of the row mask that holds this publish's verdict
    for (int i = tid; i < TP; i += kThreads) {
        const int pl = plt[(size_t)t * TP + i];
        sKey[i] = pl < 0 ? 64
                         : min(pl, 31) + (pdt[(size_t)t * TP + i] > 0 ? 32 : 0);
    }

    const int W = seg_max / 32;
    const int cb = sh + warp * 32;  // this warp's first column in a stage
    for (int c = c_begin; c < c_end; ++c) {
        if (c + 1 < c_end)
            load_chunk<KP>(stages + ((c + 1) & 1) * Lay::kStage, F_t, t1, eff,
                           flags, K, S, base + (c + 1) * kChunk, tid);
        cp_async_commit();  // (an empty group on the last chunk)
        cp_async_wait1();   // this chunk's group has landed
        __syncthreads();

        unsigned char* stage = stages + (c & 1) * Lay::kStage;
        uint16_t* sF = reinterpret_cast<uint16_t*>(stage);
        const float* sT1 = reinterpret_cast<const float*>(stage + Lay::kStageF);
        const int32_t* sEff = reinterpret_cast<const int32_t*>(sT1 + kChunkPad);
        const int32_t* sFl = sEff + kChunkPad;

        // lane = row cb + lane: its t1 - 1 as three bf16-exact F rows (the
        // warp reads only its own 32 columns), and its row mask: bit k of
        // `len` = "a publish of key k (no $) may match"; transposed, word k
        // of the warp's table holds the 32 rows' bits of key k
        uint32_t* okt = sMask + warp * kMaskWords;
        {
            const int r = cb + lane;
            const int tv = (int)sT1[r];
            const float piece[kT1Cols] = {(float)((tv & 255) - 1),
                                         (float)(tv & 0xff00),
                                         (float)(tv & ~0xffff)};
#pragma unroll
            for (int i = 0; i < kT1Cols; ++i)
                sF[(K + i) * kChunkPad + r] =
                    (uint16_t)(__float_as_uint(piece[i]) >> 16);
            const int row = base + c * kChunk + r;
            const int fl = sFl[r];
            const int e = sEff[r];
            const bool fw = (fl & 2) != 0;
            const bool row_ok =
                (fl & 4) != 0
                && (mode == kDense ? row < glob_pad
                    : mode == kShard ? row >= glob_pad
                                     : row >= glob_pad
                                       && (mode == kProbeB ? fw : !fw));
            uint32_t len;
            if (fl & 1)
                len = e <= 0 ? 0xffffffffu : e < 32 ? 0xffffffffu << e : 0u;
            else
                len = e >= 0 && e < 32 ? 1u << e : 0u;
            const uint32_t ok = transpose32(row_ok ? len : 0u, lane);
            okt[lane] = ok;
            okt[32 + lane] = ok & __ballot_sync(0xffffffffu, !fw);  // $ pubs
            if (lane == 0) okt[64] = 0u;
            __syncwarp();
        }

        // B fragments of the warp's 4 n-tiles (rows cb + 8nt + g)
        uint32_t b[4][NKS][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const int col = cb + 8 * nt + g;
#pragma unroll
            for (int ks = 0; ks < NKS; ++ks) {
                const uint16_t* f = sF + (16 * ks + 2 * q) * kChunkPad + col;
                b[nt][ks][0] = (uint32_t)f[0] | ((uint32_t)f[kChunkPad] << 16);
                b[nt][ks][1] = (uint32_t)f[8 * kChunkPad]
                               | ((uint32_t)f[9 * kChunkPad] << 16);
            }
        }

        // lane q = 0 finishes publish m0 + g of each tile, q = 1 m0 + g + 8;
        // the next tile's A fragments and mask word load while this one
        // computes.
        // A lane's sign bytes hold rows 8nt + 2q (d[0], d[2]) and 8nt + 2q + 1
        // (d[1], d[3]) of the warp's 32: m_even / m_odd pick those bits.
        const int pl = g + 8 * (q & 1);
        uint32_t* o = sOut + pl * kWords + warp;
        const uint32_t m_even = 0x01010101u << (2 * q);
        const uint32_t m_odd = 0x02020202u << (2 * q);
        const uint16_t* ga = sG + (lane & 15) * GS + (lane >> 4) * 8;
        uint32_t a[NKS][4];
        load_a<NKS>(a, ga);
        uint32_t okw = okt[sKey[pl]];
#pragma unroll 1
        for (int m0 = 0; m0 < TP; m0 += 16) {
            const int mn = m0 + 16 < TP ? m0 + 16 : m0;
            uint32_t an[NKS][4];
            load_a<NKS>(an, ga + mn * GS);
            const uint32_t okw_n = okt[sKey[mn + pl]];
            float d[4][4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                mma_bf16_first(d[nt], a[0], b[nt][0]);
#pragma unroll
                for (int ks = 1; ks < NKS; ++ks) mma_bf16(d[nt], a[ks], b[nt][ks]);
            }
            // publishes m0 + g (lo) and m0 + g + 8 (hi): byte nt = n-tile nt
            const uint32_t lo =
                (sign_bytes(d[0][0], d[1][0], d[2][0], d[3][0]) & m_even)
                | (sign_bytes(d[0][1], d[1][1], d[2][1], d[3][1]) & m_odd);
            const uint32_t hi =
                (sign_bytes(d[0][2], d[1][2], d[2][2], d[3][2]) & m_even)
                | (sign_bytes(d[0][3], d[1][3], d[2][3], d[3][3]) & m_odd);
            // OR the quad: q = 0 gathers lo, q = 1 hi (q = 2, 3 help)
            uint32_t w = (q & 1) ? hi : lo;
            w |= __shfl_xor_sync(0xffffffffu, (q & 1) ? lo : hi, 1);
            w |= __shfl_xor_sync(0xffffffffu, w, 2);
            o[m0 * kWords] = w & okw;  // q = 2, 3 repeat q = 0, 1
#pragma unroll
            for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
                for (int i = 0; i < 4; ++i) a[ks][i] = an[ks][i];
            okw = okw_n;
        }
        __syncthreads();

        // [TP][8] words -> out[t, p, 8c .. 8c + 7]: 16-byte streaming stores
        const uint4* s4 = reinterpret_cast<const uint4*>(sOut);
        for (int i = tid; i < TP * (kWords / 4); i += kThreads) {
            const int p = i / (kWords / 4);
            const int h = i - p * (kWords / 4);
            __stcs(reinterpret_cast<uint4*>(out + ((size_t)t * TP + p) * W
                                            + c * kWords + 4 * h), s4[i]);
        }
    }
}

// Let the template launch with `smem` bytes of dynamic shared memory on
// the current device: the cap is raised when a launch needs more, and never
// lowered, under a lock. Host threads launch the same template with other
// tile widths at once (a collector keeps two dispatches in flight: a probe
// of 256 publishes beside a dense tile of 128); a cap set to each launch's
// own size could drop below another thread's launch between its set and
// its launch, which the runtime then refuses (cudaErrorInvalidValue).
template <int KP>
int allow_smem(size_t smem) {
    constexpr int kDevices = 64;
    static std::mutex mu;
    static size_t cap[kDevices];
    if (smem <= 48 * 1024) return 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> hold(mu);
    if (smem <= cap[dev]) return 0;
    e = cudaFuncSetAttribute(tile_match_kernel<KP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    cap[dev] = smem;
    return 0;
}

template <int KP>
int launch(const void* F_t, const void* t1, const void* eff,
           const void* flags, const void* Gt, const void* plt,
           const void* pdt, const void* start, void* out, int T, int TP,
           int K, int S, int seg_max, int glob_pad, int mode,
           cudaStream_t stream) {
    const size_t smem = Layout<KP>::bytes(TP);
    const int rc = allow_smem<KP>(smem);
    if (rc != 0) return rc;
    const int nchunks = seg_max / kChunk;
    const int per_block = mode == kDense ? kDenseChunksPerBlock
                                         : kChunksPerBlock;
    const dim3 grid(T, (nchunks + per_block - 1) / per_block);
    tile_match_kernel<KP><<<grid, kThreads, smem, stream>>>(
        static_cast<const uint16_t*>(F_t), static_cast<const float*>(t1),
        static_cast<const int32_t*>(eff), static_cast<const int32_t*>(flags),
        static_cast<const uint16_t*>(Gt), static_cast<const int32_t*>(plt),
        static_cast<const int32_t*>(pdt), static_cast<const int32_t*>(start),
        static_cast<int32_t*>(out), K, S, TP, seg_max, glob_pad, mode);
    return (int)cudaGetLastError();
}

// Calls fn(std::integral_constant<int, KP>) for the compiled width KP of
// K: K + kT1Cols rounded up to a k-step (16..112 for K <= 96); `bad` for
// any other K.
template <class Fn>
int with_kp(int K, int bad, Fn fn) {
    switch ((K + kT1Cols + 15) / 16 * 16) {
        case 16: return fn(std::integral_constant<int, 16>{});
        case 32: return fn(std::integral_constant<int, 32>{});
        case 48: return fn(std::integral_constant<int, 48>{});
        case 64: return fn(std::integral_constant<int, 64>{});
        case 80: return fn(std::integral_constant<int, 80>{});
        case 96: return fn(std::integral_constant<int, 96>{});
        case 112: return fn(std::integral_constant<int, 112>{});
        default: return bad;
    }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// The caller checks shapes, types, alignment, window bounds, K <= 96,
// S % 8 == 0, TP % 16 == 0 and seg_max % 256 == 0. mode: 0 probe A, 1
// probe B, 2 dense, 3 shard (see the top of this file).
extern "C" int tile_match_launch(const void* F_t, const void* t1,
                                 const void* eff, const void* flags,
                                 const void* Gt, const void* plt,
                                 const void* pdt, const void* start,
                                 void* out, int T, int TP, int K, int S,
                                 int seg_max, int glob_pad, int mode,
                                 void* stream) {
    if (TP <= 0 || TP % 16 || S % 8 || seg_max <= 0 || seg_max % kChunk
        || mode < 0 || mode > kShard)
        return (int)cudaErrorInvalidValue;
    return with_kp(K, (int)cudaErrorInvalidValue, [&](auto kp) {
        return launch<decltype(kp)::value>(
            F_t, t1, eff, flags, Gt, plt, pdt, start, out, T, TP, K, S,
            seg_max, glob_pad, mode, static_cast<cudaStream_t>(stream));
    });
}
