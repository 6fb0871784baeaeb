// The payload-predicate phase for Hopper (sm_90a): pair verdicts and window
// folds of one publish batch in one dispatch.
//
// Replaces vernemq_tpu/ops/predicate_kernel.py:predicate_phase (and its
// predicate-only form eval_pairs), jnp that XLA fuses into one pass:
// _pair_keep evaluated over the (publish, predicate) pairs and again over
// the aggregation folds' gates, then _agg_partials' four segment reductions
// and the in-place update of the accumulator table acc [W, 4] (count, sum,
// min, max).
//
// Verdict of pair k (pub = pair_pub[k], row = pair_pred[k]):
//
//   x = feats[pub, field[row]]; NaN means the field is missing
//   op PAD                      -> false
//   missing                     -> op == NULL || op == TRUE
//   GT GE LT LE EQ NE           -> x ? a[row]          (float32 compare)
//   RANGE                       -> a <= x <= b
//   IN                          -> x integral in 0..63 and bit x of (mlo, mhi)
//   EXISTS / NULL / TRUE        -> true / false / true
//
// Fold k (slot, pub, field, gate, valid): it counts iff valid, the gate
// row's verdict on pub is true, and the value is present ($COUNT, field < 0,
// counts every message with the value 0). Per slot the batch's partials are
// count, sum, min and max of the counting values (identities 0, 0, +inf,
// -inf); acc gets count and sum added, and min and max merged where the
// slot was touched (count > 0). Indexes are clamped into their arrays (the
// reference's gather rule); a slot outside 0..W-1 folds nothing.
//
// What bounds it: bytes. At the telemetry storm of bench config 13 (2048
// publishes x 512 predicates, 2048 x 128 folds into 16,384 window slots) it
// reads the pair and fold arrays (~14 MB), writes a byte per verdict, and
// touches feats, the predicate table and acc, a few hundred KB: ~0.004 ms at
// 3.35 TB/s. The XLA program keeps the per-pair gathers, the 11-way select
// and the segment reductions out of device memory by fusion; eager PyTorch
// would write each of them out (~100 launches over [P] tensors). At that
// size a launch's ramp and drain and the gaps between dependent launches
// are a large share of the time, so the design keeps the chain short.
//
// Design.
// - Two launches, no memset. The folds reduce into a per-slot scratch held
//   zeroed between dispatches: the merge clears every slot it reads, and the
//   caller allocates it zeroed once and drops it after any failure (a
//   half-folded scratch must never reach the next dispatch). It is two
//   arrays of 8-byte slots: (count, sum) as a float2, and (~min key, max
//   key) as two unsigned words.
// - Launch 1, the pass: one wave of blocks (kBlocksPerSm an SM), split by
//   role: the first blocks walk the pairs, the rest the folds, so the pair
//   stream (bound by bytes) and the fold atomics (bound by the L2's atomic
//   rate) run side by side; the blocks are shared in proportion to the
//   work (a fold weighs kFoldWeight groups of four pairs). A pair thread
//   takes four consecutive pairs at once — one 16-byte load each of
//   pair_pub and pair_pred (streaming, read once) and one 32-bit store of
//   the four verdict bytes — when the three arrays are 16 / 16 / 4-byte
//   aligned, otherwise (and for the last P % 4 pairs) one pair at a time;
//   its next group's loads are in flight while it evaluates this one, and
//   its first group's while the block stages the table. Each block stages
//   the predicate table in shared memory once, as one 16-byte row per
//   predicate (op, clamped field, and the two operands the op reads: a and
//   b, or the IN mask's two words), so a verdict is one shared load, one
//   feats load (a small array that stays in L1) and a switch; a table of
//   more than kSmemRows rows is read from global memory row by row
//   instead. A fold thread evaluates its gate with the same function. Its
//   count and sum go in one vector atomic add of (1, value) on the float2
//   (Hopper's atomicAdd on float2; the count is exact in float while a
//   dispatch has fewer than 2^24 folds, and past that it is kept as an
//   unsigned add in the same word). Min and max are unsigned maxima over
//   an order-preserving encoding of the float's bits, taken with an atomic
//   only when the value would move them (a read of the slot through L2
//   first: a stale read only costs an atomic that changes nothing). The
//   encoding orders -0.0 below +0.0 (the rule for min and max here and in
//   the plain version) and maps every non-NaN float above 0, so the zeroed
//   scratch is the identity of both. Sums are float adds whose order varies
//   from run to run, so they are equal only up to rounding.
// - Launch 2, the merge, one thread per slot, launched as a programmatic
//   dependent of the pass (Hopper's programmatic dependent launch): its
//   blocks are scheduled while the pass drains and wait in
//   griddepcontrol.wait until the pass has finished and its atomics are
//   visible. It decodes the scratch into the partials [4, W] (count, sum,
//   min, max; +inf / -inf where untouched), updates acc in place and zeroes
//   the slot. Because the update is in place, a failure part way leaves acc
//   and the scratch undefined: the caller drops both and re-uploads acc.
//   (A last-block ticket that merged inside the pass would leave the 16,384
//   slots to one block; the dependent launch spreads them over W / 256.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// opcodes of vernemq_tpu_torch/filters/predicate.py
constexpr int OP_PAD = 0, OP_GT = 1, OP_GE = 2, OP_LT = 3, OP_LE = 4,
              OP_EQ = 5, OP_NE = 6, OP_RANGE = 7, OP_IN = 8, OP_EXISTS = 9,
              OP_NULL = 10, OP_TRUE = 11;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 6;     // the pass's grid: one wave of these
constexpr int kSmemRows = 2048;     // table rows staged in shared memory
constexpr int kFoldWeight = 1;      // a fold's work in groups of four pairs

struct Table {
    const int* op;
    const int* field;
    const float* a;
    const float* b;
    const int* mlo;
    const int* mhi;
    int np;
};

__device__ __forceinline__ int clampi(int v, int hi) {
    return v < 0 ? 0 : (v > hi ? hi : v);
}

// Row r of the table as the pass reads it: {op, field clamped into feats,
// the op's first operand (a, or mlo for IN), its second (b, or mhi for IN)}
__device__ __forceinline__ int4 table_row(const Table& t, int r, int F) {
    const int op = __ldg(t.op + r);
    const bool in = op == OP_IN;
    return make_int4(op, clampi(__ldg(t.field + r), F - 1),
                     in ? __ldg(t.mlo + r) : __float_as_int(__ldg(t.a + r)),
                     in ? __ldg(t.mhi + r)
                        : (op == OP_RANGE ? __float_as_int(__ldg(t.b + r))
                                          : 0));
}

__device__ __forceinline__ bool verdict(int4 row, const float* feats, int B,
                                        int F, int pub) {
    const int op = row.x;
    if (op == OP_PAD) return false;
    const float x = __ldg(feats + (size_t)clampi(pub, B - 1) * F + row.y);
    if (isnan(x)) return op == OP_NULL || op == OP_TRUE;
    const float a = __int_as_float(row.z);
    switch (op) {
        case OP_TRUE: return true;
        case OP_GT: return x > a;
        case OP_GE: return x >= a;
        case OP_LT: return x < a;
        case OP_LE: return x <= a;
        case OP_EQ: return x == a;
        case OP_NE: return x != a;
        case OP_RANGE: return x >= a && x <= __int_as_float(row.w);
        case OP_IN: {
            if (!(x == floorf(x) && x >= 0.f && x < 64.f)) return false;
            const int c = (int)x;
            const unsigned w = (unsigned)(c < 32 ? row.z : row.w);
            return (w >> (c & 31)) & 1u;
        }
        case OP_EXISTS: return true;
        default: return false;  // OP_NULL on a present value, unknown ops
    }
}

// float bits -> unsigned key in float order (-0.0 < +0.0); every non-NaN
// float maps above 0x007FFFFE, so 0 is free to mean "nothing folded"
__device__ __forceinline__ unsigned order_key(float v) {
    const unsigned b = __float_as_uint(v);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// Stage the table in shared memory (every thread of the block calls it)
__device__ __forceinline__ void stage_table(int4* s_rows, const Table& t,
                                            int F) {
    for (int r = threadIdx.x; r < t.np; r += kThreads)
        s_rows[r] = table_row(t, r, F);
    __syncthreads();
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
predicate_pass_kernel(Table t, const float* __restrict__ feats, int B, int F,
                      const int* __restrict__ pair_pub,
                      const int* __restrict__ pair_pred,
                      unsigned char* __restrict__ keep, int P, int vec,
                      int pair_blocks,
                      const int* __restrict__ agg_slot,
                      const int* __restrict__ agg_pub,
                      const int* __restrict__ agg_field,
                      const int* __restrict__ agg_gate,
                      const unsigned char* __restrict__ agg_valid, int A,
                      float2* __restrict__ cs, uint2* __restrict__ mm, int W,
                      int wide) {
    extern __shared__ int4 s_rows[];
    // the merge may be scheduled now; it waits for this grid's end itself
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    auto keep_of = [&](int pub, int r) -> bool {
        r = clampi(r, t.np - 1);
        return verdict(kStaged ? s_rows[r] : table_row(t, r, F), feats, B, F,
                       pub);
    };
    const bool pairs = (int)blockIdx.x < pair_blocks;
    const int nb = pairs ? pair_blocks : (int)gridDim.x - pair_blocks;
    const long long i0 =
        (long long)(pairs ? blockIdx.x : blockIdx.x - pair_blocks) * kThreads
        + threadIdx.x;
    const long long stride = (long long)nb * kThreads;

    if (pairs) {
        const long long groups = vec ? P / 4 : 0;
        const int4* pub4 = reinterpret_cast<const int4*>(pair_pub);
        const int4* pred4 = reinterpret_cast<const int4*>(pair_pred);
        int4 p = make_int4(0, 0, 0, 0), r = p;
        if (i0 < groups) {  // in flight while the block stages the table
            p = __ldcs(pub4 + i0);
            r = __ldcs(pred4 + i0);
        }
        if (kStaged) stage_table(s_rows, t, F);
        for (long long g = i0; g < groups; g += stride) {
            int4 pn = p, rn = r;
            if (g + stride < groups) {  // the next group's, likewise
                pn = __ldcs(pub4 + g + stride);
                rn = __ldcs(pred4 + g + stride);
            }
            const unsigned v = (unsigned)keep_of(p.x, r.x)
                               | (unsigned)keep_of(p.y, r.y) << 8
                               | (unsigned)keep_of(p.z, r.z) << 16
                               | (unsigned)keep_of(p.w, r.w) << 24;
            __stcs(reinterpret_cast<unsigned*>(keep) + g, v);
            p = pn;
            r = rn;
        }
        for (long long k = 4 * groups + i0; k < P; k += stride)
            keep[k] = keep_of(__ldcs(pair_pub + k), __ldcs(pair_pred + k));
        return;
    }

    // a fold's five inputs load together, and the next fold's are in
    // flight while this one is evaluated (the first's while the block
    // stages the table); an invalid fold takes slot -1, which folds nothing
    auto load = [&](long long k) {
        if (k >= A) return make_int4(0, 0, 0, -1);
        const bool ok = agg_valid[k];
        const int4 q = make_int4(__ldcs(agg_pub + k), __ldcs(agg_gate + k),
                                 __ldcs(agg_field + k), __ldcs(agg_slot + k));
        return make_int4(q.x, q.y, q.z, ok ? q.w : -1);
    };
    int4 q = load(i0);
    if (kStaged) stage_table(s_rows, t, F);
    for (long long k = i0; k < A; k += stride) {
        const int4 qn = load(k + stride);
        const int pub = q.x, f = q.z, s = q.w;
        const bool counts = s >= 0 && s < W && keep_of(pub, q.y);
        q = qn;
        if (!counts) continue;
        float v = 0.f;
        if (f >= 0) {
            v = __ldg(feats + (size_t)clampi(pub, B - 1) * F
                      + clampi(f, F - 1));
            if (isnan(v)) continue;
        }
        if (wide) {  // 2^24 folds or more: an exact unsigned count
            atomicAdd(reinterpret_cast<unsigned*>(cs + s), 1u);
            atomicAdd(&cs[s].y, v);
        } else {
            atomicAdd(cs + s, make_float2(1.f, v));
        }
        const unsigned key = order_key(v);
        const uint2 cur = __ldcg(mm + s);  // L2's view; stale is only slower
        if (~key > cur.x) atomicMax(&mm[s].x, ~key);  // min as max of ~key
        if (key > cur.y) atomicMax(&mm[s].y, key);
    }
}

__global__ void __launch_bounds__(kThreads)
predicate_merge_kernel(float2* __restrict__ cs, uint2* __restrict__ mm,
                       float* __restrict__ part, float* __restrict__ acc,
                       int W, int wide) {
    // the pass's folds are complete and visible past this point
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const int s = blockIdx.x * kThreads + threadIdx.x;
    if (s >= W) return;
    const float2 q = cs[s];
    const uint2 m = mm[s];
    cs[s] = make_float2(0.f, 0.f);  // held zeroed for the next dispatch
    mm[s] = make_uint2(0u, 0u);
    const unsigned c = wide ? __float_as_uint(q.x) : (unsigned)q.x;
    const float sm = q.y;
    const float cf = (float)c;
    part[s] = cf;
    part[W + s] = sm;
    float4 a = reinterpret_cast<float4*>(acc)[s];
    a.x += cf;
    a.y += sm;
    if (c) {
        const unsigned mnk = ~m.x, mxk = m.y;
        part[2 * W + s] = from_key(mnk);
        part[3 * W + s] = from_key(mxk);
        a.z = from_key(min(order_key(a.z), mnk));
        a.w = from_key(max(order_key(a.w), mxk));
    } else {
        part[2 * W + s] = __uint_as_float(0x7F800000u);   // +inf
        part[3 * W + s] = __uint_as_float(0xFF800000u);   // -inf
    }
    reinterpret_cast<float4*>(acc)[s] = a;
}

}  // namespace

// One dispatch of the phase on `stream`. Pairs: P verdicts into keep (one
// byte each). Folds: A entries reduced into scratch (4 * W 32-bit words,
// 16-byte aligned, which must be zero on entry and are zero again when the
// dispatch ends), then, when W > 0, partials [4, W] written and acc [W, 4]
// updated in place. Returns the CUDA error of the launches (0 on success);
// after an error the scratch and acc are undefined.
extern "C" int predicate_phase_launch(
        const void* op, const void* field, const void* a, const void* b,
        const void* mlo, const void* mhi, int np, const void* feats, int B,
        int F, const void* pair_pub, const void* pair_pred, void* keep, int P,
        const void* agg_slot, const void* agg_pub, const void* agg_field,
        const void* agg_gate, const void* agg_valid, int A, void* acc, int W,
        void* scratch, void* part, void* stream) {
    if (np <= 0 || B <= 0 || F <= 0 || P < 0 || A < 0 || W < 0
        || (A > 0 && W == 0) || (W > 0 && (!acc || !scratch || !part))
        || reinterpret_cast<uintptr_t>(acc) % 16
        || reinterpret_cast<uintptr_t>(scratch) % 16)
        return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    const Table t{static_cast<const int*>(op), static_cast<const int*>(field),
                  static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<const int*>(mlo), static_cast<const int*>(mhi),
                  np};
    auto* cs = static_cast<float2*>(scratch);
    auto* mm = reinterpret_cast<uint2*>(cs + W);
    const int wide = A >= (1 << 24);
    const bool passed = (long long)P + A > 0;
    if (passed) {
        int dev = 0, sms = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return (int)e;
        // one wave, shared between the roles in proportion to their work
        const long long groups = ((long long)P + 3) / 4;
        const long long need_p = (groups + kThreads - 1) / kThreads;
        const long long need_f = ((long long)A + kThreads - 1) / kThreads;
        const long long wave = (long long)sms * kBlocksPerSm;
        long long nbp = need_p, nbf = need_f;
        if (need_p && need_f) {
            nbp = wave * groups / (groups + kFoldWeight * (long long)A);
            nbp = nbp < 1 ? 1 : (nbp > wave - 1 ? wave - 1 : nbp);
            nbf = wave - nbp;
        }
        nbp = need_p < nbp ? need_p : (nbp < wave ? nbp : wave);
        nbf = need_f < nbf ? need_f : (nbf < wave ? nbf : wave);
        const int vec = (reinterpret_cast<uintptr_t>(pair_pub) % 16 == 0
                         && reinterpret_cast<uintptr_t>(pair_pred) % 16 == 0
                         && reinterpret_cast<uintptr_t>(keep) % 4 == 0);
        const unsigned grid = (unsigned)(nbp + nbf);
        const bool staged = np <= kSmemRows;
        auto kernel = staged ? predicate_pass_kernel<true>
                             : predicate_pass_kernel<false>;
        kernel<<<grid, kThreads, staged ? sizeof(int4) * (size_t)np : 0, s>>>(
            t, static_cast<const float*>(feats), B, F,
            static_cast<const int*>(pair_pub),
            static_cast<const int*>(pair_pred),
            static_cast<unsigned char*>(keep), P, vec, (int)nbp,
            static_cast<const int*>(agg_slot),
            static_cast<const int*>(agg_pub),
            static_cast<const int*>(agg_field),
            static_cast<const int*>(agg_gate),
            static_cast<const unsigned char*>(agg_valid), A, cs, mm, W, wide);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    if (W > 0) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((unsigned)((W + kThreads - 1) / kThreads));
        cfg.blockDim = dim3(kThreads);
        cfg.dynamicSmemBytes = 0;
        cfg.stream = s;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        attr[0].val.programmaticStreamSerializationAllowed = 1;
        cfg.attrs = attr;
        cfg.numAttrs = passed ? 1 : 0;  // a dependent of the pass, if any
        const cudaError_t e = cudaLaunchKernelEx(
            &cfg, predicate_merge_kernel, cs, mm, static_cast<float*>(part),
            static_cast<float*>(acc), W, wide);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}
