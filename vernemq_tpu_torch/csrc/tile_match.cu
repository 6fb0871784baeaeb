// Probe-window tile matcher for Hopper (sm_90a).
//
// Replaces vernemq_tpu/ops/pallas_match.py:window_tiles_packed (the Pallas
// body _tile_kernel) and the XLA form match_kernel.py:_window_tiles_sel.
// For tile t (TP publishes against seg_max contiguous table rows starting at
// start[t]) and window row j, publish p matches row r = start[t] + j iff
//
//   G[t,p,:] . F_t[:,r] + t1[r] == 0        (every concrete level matches)
//   has_hash[r] ? plen[p] >= eff[r] : plen[p] == eff[r]
//   !(pd[p] && first_wild[r])               ($-topics skip root wildcards)
//   active[r] && r >= glob_pad              (region 0 is the dense phase's)
//   wild_rows ? first_wild[r] : !first_wild[r]   (probe B / probe A split)
//
// and out[t, p, j / 32] holds that verdict in bit j % 32 (int32 words).
//
// Design. Grid (T, seg_max / 256); a block owns 256 consecutive window rows
// as 8 warps of 32. It stages its tile's G (TP x K bf16, zero-padded to
// KP = K rounded up to 8, so 16-byte loads read 8 values) and plen/pd in
// shared memory. Each thread keeps its row's K operand column, t1, eff and
// flags in registers and loops over the TP publishes with fp32 FMAs; the
// warp's 32 verdicts become one word through __ballot_sync, which lane 0
// stores. F_t is read once per tile; the output is written once.
//
// Exactness. Every operand is an integer of magnitude at most 2^16 (bf16
// holds it exactly), every product is an integer, and for K <= 96 (16
// levels, 24-bit ids) the sum of |products| plus t1 stays below 1.3e7 <
// 2^24: every partial sum is an exact float32 integer whatever the order,
// so "== 0" is exact, as on the TPU's MXU.
//
// Bound at the headline shapes (1M subscriptions, K = 40, T = 24 tiles of
// TP = 256 publishes, seg_max = 262,144): a tile multiplies 40 bf16 values
// per row against 256 publishes, 10,240 FMAs for 80 bytes of F_t, so the
// kernel is far above the memory roofline; as written its floor is the
// SM's fp32 FMA rate (about 67 TFLOP/s), plus one shared-memory load and
// eight conversions per 8 FMAs. The bf16 tensor cores (989 TFLOP/s dense)
// would compute the same exact sums: mma/wgmma with TMA-fed F_t tiles, and
// the extraction fused behind the bit-pack, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;  // window rows per block

__device__ __forceinline__ float bf16_lo(uint32_t w) {
    return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
}

__host__ __device__ constexpr size_t g_offset(int TP) {
    // plen[TP] and pd[TP] int32 first, then G at a 16-byte boundary
    return ((size_t)2 * TP * sizeof(int32_t) + 15) & ~(size_t)15;
}

template <int KP>
__global__ void __launch_bounds__(kRows)
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
                  int wild_rows) {
    extern __shared__ __align__(16) unsigned char smem[];
    int32_t* s_plen = reinterpret_cast<int32_t*>(smem);
    int32_t* s_pd = s_plen + TP;
    uint16_t* s_g = reinterpret_cast<uint16_t*>(smem + g_offset(TP));

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const uint16_t* g_src = Gt + (size_t)t * TP * K;
    for (int i = tid; i < TP * KP; i += kRows) {
        const int p = i / KP;
        const int k = i - p * KP;
        s_g[i] = k < K ? g_src[(size_t)p * K + k] : (uint16_t)0;
    }
    for (int i = tid; i < TP; i += kRows) {
        s_plen[i] = plt[(size_t)t * TP + i];
        s_pd[i] = pdt[(size_t)t * TP + i];
    }

    // the wrapper guarantees start[t] + seg_max <= S
    const int row = start[t] + blockIdx.y * kRows + tid;
    float f[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k)
        f[k] = k < K ? __uint_as_float((uint32_t)F_t[(size_t)k * S + row] << 16)
                     : 0.0f;
    const float base = t1[row];
    const int e = eff[row];
    const int fl = flags[row];
    const bool hh = (fl & 1) != 0;
    const bool fw = (fl & 2) != 0;
    const bool act = (fl & 4) != 0;
    const bool row_ok = act && row >= glob_pad && (wild_rows ? fw : !fw);
    __syncthreads();

    const int lane = tid & 31;
    const int words = seg_max / 32;
    int32_t* o = out + (size_t)t * TP * words + blockIdx.y * (kRows / 32)
                 + (tid >> 5);
    for (int p = 0; p < TP; ++p) {
        const uint4* g = reinterpret_cast<const uint4*>(s_g + (size_t)p * KP);
        float acc = base;
#pragma unroll
        for (int q = 0; q < KP / 8; ++q) {
            const uint4 v = g[q];
            acc = fmaf(bf16_lo(v.x), f[8 * q + 0], acc);
            acc = fmaf(bf16_hi(v.x), f[8 * q + 1], acc);
            acc = fmaf(bf16_lo(v.y), f[8 * q + 2], acc);
            acc = fmaf(bf16_hi(v.y), f[8 * q + 3], acc);
            acc = fmaf(bf16_lo(v.z), f[8 * q + 4], acc);
            acc = fmaf(bf16_hi(v.z), f[8 * q + 5], acc);
            acc = fmaf(bf16_lo(v.w), f[8 * q + 6], acc);
            acc = fmaf(bf16_hi(v.w), f[8 * q + 7], acc);
        }
        const int plen = s_plen[p];
        const bool len_ok = hh ? plen >= e : plen == e;
        const bool m = row_ok && acc == 0.0f && len_ok && !(s_pd[p] && fw);
        const unsigned bits = __ballot_sync(0xffffffffu, m);
        if (lane == 0) o[(size_t)p * words] = (int32_t)bits;
    }
}

template <int KP>
int launch(const void* F_t, const void* t1, const void* eff,
           const void* flags, const void* Gt, const void* plt,
           const void* pdt, const void* start, void* out, int T, int TP,
           int K, int S, int seg_max, int glob_pad, int wild_rows,
           cudaStream_t stream) {
    const size_t smem = g_offset(TP) + (size_t)TP * KP * sizeof(uint16_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            tile_match_kernel<KP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(T, seg_max / kRows);
    tile_match_kernel<KP><<<grid, kRows, smem, stream>>>(
        static_cast<const uint16_t*>(F_t), static_cast<const float*>(t1),
        static_cast<const int32_t*>(eff), static_cast<const int32_t*>(flags),
        static_cast<const uint16_t*>(Gt), static_cast<const int32_t*>(plt),
        static_cast<const int32_t*>(pdt), static_cast<const int32_t*>(start),
        static_cast<int32_t*>(out), K, S, TP, seg_max, glob_pad, wild_rows);
    return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// The caller checks shapes, types, window bounds and seg_max % 256 == 0.
extern "C" int tile_match_launch(const void* F_t, const void* t1,
                                 const void* eff, const void* flags,
                                 const void* Gt, const void* plt,
                                 const void* pdt, const void* start,
                                 void* out, int T, int TP, int K, int S,
                                 int seg_max, int glob_pad, int wild_rows,
                                 void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VMQ_TILE_CASE(KP)                                                   \
    case KP:                                                                \
        return launch<KP>(F_t, t1, eff, flags, Gt, plt, pdt, start, out, T, \
                          TP, K, S, seg_max, glob_pad, wild_rows, st);
    switch ((K + 7) / 8 * 8) {
        VMQ_TILE_CASE(8)
        VMQ_TILE_CASE(16)
        VMQ_TILE_CASE(24)
        VMQ_TILE_CASE(32)
        VMQ_TILE_CASE(40)
        VMQ_TILE_CASE(48)
        VMQ_TILE_CASE(56)
        VMQ_TILE_CASE(64)
        VMQ_TILE_CASE(72)
        VMQ_TILE_CASE(80)
        VMQ_TILE_CASE(88)
        VMQ_TILE_CASE(96)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef VMQ_TILE_CASE
}
