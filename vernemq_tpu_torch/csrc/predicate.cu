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
// publishes x 512 predicates, 2048 x 128 folds into 8192 windows) it reads
// the pair and fold arrays (~13 MB), writes a byte per verdict, and touches
// feats, the predicate table and acc, a few hundred KB: ~0.004 ms at 3.35
// TB/s. The XLA program keeps the per-pair gathers, the 11-way select and
// the segment reductions out of device memory by fusion; eager PyTorch would
// write each of them out (~100 launches over [P] tensors).
//
// Design.
// - Launch 1, one thread per pair and per fold (grid over P + A). The
//   predicate table is small and read through the read-only cache; the
//   verdict is one switch. A fold thread evaluates its gate with the same
//   device function and reduces into a per-slot scratch with atomics: count
//   as an unsigned add (exact), sum as a float add (its order varies from
//   run to run, so sums are equal only up to rounding), min and max as
//   unsigned maxima over an order-preserving encoding of the float's bits.
//   The encoding orders -0.0 below +0.0 (the rule for min and max here and
//   in the plain version) and maps every non-NaN float above 0, so a
//   zeroed scratch is the identity of both (cudaMemsetAsync, no launch).
// - Launch 2, one thread per slot: decodes the scratch into the partials
//   [4, W] (count, sum, min, max; +inf / -inf where untouched) and updates
//   acc in place. Because the update is in place, a failure part way leaves
//   acc undefined: the caller drops its device copy and re-uploads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// opcodes of vernemq_tpu_torch/filters/predicate.py
constexpr int OP_PAD = 0, OP_GT = 1, OP_GE = 2, OP_LT = 3, OP_LE = 4,
              OP_EQ = 5, OP_NE = 6, OP_RANGE = 7, OP_IN = 8, OP_EXISTS = 9,
              OP_NULL = 10, OP_TRUE = 11;

constexpr int kThreads = 256;

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

__device__ __forceinline__ bool pair_keep(const Table& t, const float* feats,
                                          int B, int F, int pub, int row) {
    row = clampi(row, t.np - 1);
    const int op = __ldg(t.op + row);
    if (op == OP_PAD) return false;
    const int fi = clampi(__ldg(t.field + row), F - 1);
    const float x = __ldg(feats + (size_t)clampi(pub, B - 1) * F + fi);
    if (isnan(x)) return op == OP_NULL || op == OP_TRUE;
    const float a = __ldg(t.a + row);
    switch (op) {
        case OP_TRUE: return true;
        case OP_GT: return x > a;
        case OP_GE: return x >= a;
        case OP_LT: return x < a;
        case OP_LE: return x <= a;
        case OP_EQ: return x == a;
        case OP_NE: return x != a;
        case OP_RANGE: return x >= a && x <= __ldg(t.b + row);
        case OP_IN: {
            if (!(x == floorf(x) && x >= 0.f && x < 64.f)) return false;
            const int c = (int)x;
            const unsigned w = (unsigned)__ldg((c < 32 ? t.mlo : t.mhi) + row);
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

__global__ void __launch_bounds__(kThreads)
predicate_pass_kernel(Table t, const float* __restrict__ feats, int B, int F,
                      const int* __restrict__ pair_pub,
                      const int* __restrict__ pair_pred,
                      unsigned char* __restrict__ keep, int P,
                      const int* __restrict__ agg_slot,
                      const int* __restrict__ agg_pub,
                      const int* __restrict__ agg_field,
                      const int* __restrict__ agg_gate,
                      const unsigned char* __restrict__ agg_valid, int A,
                      unsigned* __restrict__ scratch, int W) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i < P) {
        keep[i] = pair_keep(t, feats, B, F, __ldg(pair_pub + i),
                            __ldg(pair_pred + i));
        return;
    }
    const long long k = i - P;
    if (k >= A || !agg_valid[k]) return;
    const int pub = __ldg(agg_pub + k);
    if (!pair_keep(t, feats, B, F, pub, __ldg(agg_gate + k))) return;
    const int f = __ldg(agg_field + k);
    float v = 0.f;
    if (f >= 0) {
        v = __ldg(feats + (size_t)clampi(pub, B - 1) * F + clampi(f, F - 1));
        if (isnan(v)) return;
    }
    const int s = __ldg(agg_slot + k);
    if (s < 0 || s >= W) return;
    const unsigned key = order_key(v);
    atomicAdd(scratch + s, 1u);
    atomicAdd(reinterpret_cast<float*>(scratch) + W + s, v);
    atomicMax(scratch + 2 * W + s, ~key);  // min as the max of ~key
    atomicMax(scratch + 3 * W + s, key);
}

__global__ void __launch_bounds__(kThreads)
predicate_merge_kernel(const unsigned* __restrict__ scratch,
                       float* __restrict__ part, float* __restrict__ acc,
                       int W) {
    const int s = blockIdx.x * kThreads + threadIdx.x;
    if (s >= W) return;
    const unsigned c = scratch[s];
    const float sm = __uint_as_float(scratch[W + s]);
    const float cf = (float)c;
    part[s] = cf;
    part[W + s] = sm;
    float4 a = reinterpret_cast<float4*>(acc)[s];
    a.x += cf;
    a.y += sm;
    if (c) {
        const unsigned mnk = ~scratch[2 * W + s], mxk = scratch[3 * W + s];
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
// byte each). Folds: A entries reduced into scratch (4 * W words, zeroed
// here), then, when W > 0, partials [4, W] written and acc [W, 4] updated
// in place. Returns the CUDA error of the launches (0 on success).
extern "C" int predicate_phase_launch(
        const void* op, const void* field, const void* a, const void* b,
        const void* mlo, const void* mhi, int np, const void* feats, int B,
        int F, const void* pair_pub, const void* pair_pred, void* keep, int P,
        const void* agg_slot, const void* agg_pub, const void* agg_field,
        const void* agg_gate, const void* agg_valid, int A, void* acc, int W,
        void* scratch, void* part, void* stream) {
    if (np <= 0 || B <= 0 || F <= 0 || P < 0 || A < 0 || W < 0
        || (A > 0 && W == 0) || (W > 0 && (!acc || !scratch || !part))
        || reinterpret_cast<uintptr_t>(acc) % 16)
        return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    const Table t{static_cast<const int*>(op), static_cast<const int*>(field),
                  static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<const int*>(mlo), static_cast<const int*>(mhi),
                  np};
    if (W > 0) {
        cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(unsigned) * 4
                                        * (size_t)W, s);
        if (e != cudaSuccess) return (int)e;
    }
    const long long n = (long long)P + A;
    if (n > 0) {
        const long long blocks = (n + kThreads - 1) / kThreads;
        if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
        predicate_pass_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
            t, static_cast<const float*>(feats), B, F,
            static_cast<const int*>(pair_pub),
            static_cast<const int*>(pair_pred),
            static_cast<unsigned char*>(keep), P,
            static_cast<const int*>(agg_slot),
            static_cast<const int*>(agg_pub),
            static_cast<const int*>(agg_field),
            static_cast<const int*>(agg_gate),
            static_cast<const unsigned char*>(agg_valid), A,
            static_cast<unsigned*>(scratch), W);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    if (W > 0) {
        predicate_merge_kernel<<<(W + kThreads - 1) / kThreads, kThreads, 0,
                                 s>>>(static_cast<const unsigned*>(scratch),
                                      static_cast<float*>(part),
                                      static_cast<float*>(acc), W);
    }
    return (int)cudaGetLastError();
}
