"""The payload-predicate phase: pair verdicts and window folds of one
publish batch in one dispatch (the hand kernel ``csrc/predicate.cu``) and
its plain PyTorch version.

The contract is the reference's (``vernemq_tpu/ops/predicate_kernel.py``):
compiled predicates are parallel arrays over predicate rows (``p_op``,
``p_field`` int32, ``p_a``/``p_b`` float32, ``p_mlo``/``p_mhi`` int32, the
64-bit ``OP_IN`` mask), a publish batch is ``feats`` float32 ``[B, F]``
(NaN = missing), and the topic match's fanout arrives as pairs
``(pair_pub, pair_pred)``. A missing value keeps only ``OP_NULL`` and
``OP_TRUE``. Aggregation folds ``(agg_slot, agg_pub, agg_field, agg_gate,
agg_valid)`` reduce into per-slot partials (count, sum, min, max) and update
the accumulator table ``acc`` float32 ``[W, 4]``.

- :func:`eval_pairs` / :func:`predicate_phase` launch the kernel for CUDA
  tensors and raise (``tile_match.KernelError`` / ``KernelInputError``) on
  what it cannot take; they never fall back. ``acc`` is updated IN PLACE
  (the reference donates it and returns a new table); both return it.
- :func:`eval_pairs_ref` / :func:`predicate_phase_ref` are the plain
  versions; the wrappers take them for tensors on the CPU only.

Min and max order ``-0.0`` below ``+0.0`` (an integer encoding of the
float's bits, in the kernel and here); count is exact; the kernel's sums
are atomic float adds whose order changes from run to run, so sums agree up
to rounding. ``launches`` counts kernel dispatches (reset it to read one
run's count).

The kernel folds into a scratch of ``[W, 4]`` words that it leaves zeroed
at the end of every dispatch, so the wrapper allocates it (zeroed) once per
device, stream and ``W`` and keeps it (:func:`held_scratch`). A dispatch
that fails may leave it half folded: the wrapper drops it when a launch
fails, and the caller drops it (:func:`drop_scratch`) with its device
``acc`` after any failure it sees later.
"""

from __future__ import annotations

import ctypes

import torch

from ..filters.predicate import (OP_EQ, OP_EXISTS, OP_GE, OP_GT, OP_IN,
                                 OP_LE, OP_LT, OP_NE, OP_NULL, OP_PAD,
                                 OP_RANGE, OP_TRUE)
from . import _build
from .tile_match import KernelError, KernelInputError

launches = 0

_INT_MAX = 0x7FFFFFFF

#: (device, stream handle, W) -> the kernel's fold scratch, int32 [W, 4],
#: zero between dispatches
_scratch = {}


def held_scratch(dev, W: int, stream: int) -> torch.Tensor:
    """The fold scratch of dispatches on ``stream`` of ``dev`` with ``W``
    slots: zeroed when it is made, and left zeroed by every dispatch that
    completes. Dispatches on one stream run in order, so they share it."""
    key = (dev, stream, W)
    s = _scratch.get(key)
    if s is None:
        s = _scratch[key] = torch.zeros((W, 4), dtype=torch.int32,
                                        device=dev)
    return s


def drop_scratch(dev=None) -> None:
    """Forget the held scratch of ``dev`` (of every device of its type when
    it names no index, of every device when None): the next dispatch
    allocates a zeroed one. Call it after any failure of a dispatch, beside
    dropping the device ``acc`` — a half-folded scratch must never reach
    the next dispatch."""
    d = None if dev is None else torch.device(dev)
    for key in [k for k in _scratch if d is None or (
            k[0].type == d.type and d.index in (None, k[0].index))]:
        del _scratch[key]


def _gather(x, idx):
    """``x[idx]`` with indexes clamped into ``x`` (the reference's gather
    rule for indexes past the end)."""
    return x[idx.long().clamp(0, x.shape[0] - 1)]


def _feat(feats, pub, field):
    B, F = feats.shape
    return feats[pub.long().clamp(0, B - 1), field.long().clamp(0, F - 1)]


def _pair_keep(p_op, p_field, p_a, p_b, p_mlo, p_mhi, feats, pair_pub,
               pair_pred):
    """bool ``[P]``: the keep verdict of each (publish, predicate) pair."""
    op = _gather(p_op, pair_pred)
    x = _feat(feats, pair_pub, _gather(p_field, pair_pred))
    a = _gather(p_a, pair_pred)
    b = _gather(p_b, pair_pred)
    missing = torch.isnan(x)
    xs = torch.where(missing, torch.zeros_like(x), x)
    code_ok = (~missing) & (xs == torch.floor(xs)) & (xs >= 0) & (xs < 64)
    cc = xs.clamp(0, 63).to(torch.int32)
    lo_bit = (_gather(p_mlo, pair_pred) >> cc.clamp(max=31)) & 1
    hi_bit = (_gather(p_mhi, pair_pred) >> (cc - 32).clamp(0, 31)) & 1
    in_mask = torch.where(cc < 32, lo_bit, hi_bit) == 1
    res = torch.zeros_like(missing)
    for code, val in ((OP_TRUE, torch.ones_like(missing)),
                      (OP_GT, xs > a), (OP_GE, xs >= a), (OP_LT, xs < a),
                      (OP_LE, xs <= a), (OP_EQ, xs == a), (OP_NE, xs != a),
                      (OP_RANGE, (xs >= a) & (xs <= b)),
                      (OP_IN, code_ok & in_mask), (OP_EXISTS, ~missing),
                      (OP_NULL, missing)):
        res = torch.where(op == code, val, res)
    keep = torch.where(missing, (op == OP_NULL) | (op == OP_TRUE), res)
    return keep & (op != OP_PAD)


def eval_pairs_ref(p_op, p_field, p_a, p_b, p_mlo, p_mhi, feats, pair_pub,
                   pair_pred):
    """Plain version of :func:`eval_pairs`."""
    return _pair_keep(p_op, p_field, p_a, p_b, p_mlo, p_mhi, feats,
                      pair_pub, pair_pred)


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 ``x`` in float order, ``-0.0`` below ``+0.0``
    (its own inverse: :func:`from_key`)."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ _INT_MAX, bits)


def from_key(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k < 0, k ^ _INT_MAX, k).view(torch.float32)


_KEY_INF = 0x7F800000          # order_key(+inf)
_KEY_NINF = -0x7F800000 - 1    # order_key(-inf)


def _agg_partials(acc, feats, agg_slot, agg_pub, agg_field, agg_valid,
                  W: int):
    """Per-slot partials of the batch's folds and the in-place update of
    ``acc``; invalid folds (and slots outside ``0..W-1``) fold nothing."""
    countlike = agg_field < 0  # $COUNT: every message counts, value 0
    raw = _feat(feats, agg_pub, agg_field.clamp(min=0))
    val = torch.where(countlike, torch.zeros_like(raw), raw)
    valid = (agg_valid & (countlike | ~torch.isnan(raw))
             & (agg_slot >= 0) & (agg_slot < W))
    seg = torch.where(valid, agg_slot, torch.full_like(agg_slot, W)).long()
    dev = acc.device
    cnt_i = torch.zeros(W + 1, dtype=torch.int64, device=dev).index_add_(
        0, seg, torch.ones_like(seg))
    cnt = cnt_i[:W].to(torch.float32)
    sm = torch.zeros(W + 1, dtype=torch.float32, device=dev).index_add_(
        0, seg, torch.where(valid, val, torch.zeros_like(val)))[:W]
    key = order_key(val)
    mn_k = torch.full((W + 1,), _KEY_INF, dtype=torch.int32,
                      device=dev).scatter_reduce_(0, seg, key, "amin")[:W]
    mx_k = torch.full((W + 1,), _KEY_NINF, dtype=torch.int32,
                      device=dev).scatter_reduce_(0, seg, key, "amax")[:W]
    touched = cnt_i[:W] > 0
    acc[:, 0] += cnt
    acc[:, 1] += sm
    acc[:, 2] = from_key(torch.where(
        touched, torch.minimum(order_key(acc[:, 2]), mn_k),
        order_key(acc[:, 2])))
    acc[:, 3] = from_key(torch.where(
        touched, torch.maximum(order_key(acc[:, 3]), mx_k),
        order_key(acc[:, 3])))
    return acc, cnt, sm, from_key(mn_k), from_key(mx_k)


def predicate_phase_ref(p_op, p_field, p_a, p_b, p_mlo, p_mhi, acc, feats,
                        pair_pub, pair_pred, agg_slot, agg_pub, agg_field,
                        agg_gate, agg_valid, *, W: int):
    """Plain version of :func:`predicate_phase`."""
    keep = _pair_keep(p_op, p_field, p_a, p_b, p_mlo, p_mhi, feats,
                      pair_pub, pair_pred)
    gate_ok = _pair_keep(p_op, p_field, p_a, p_b, p_mlo, p_mhi, feats,
                         agg_pub, agg_gate)
    acc, cnt, sm, mn, mx = _agg_partials(acc, feats, agg_slot, agg_pub,
                                         agg_field, agg_valid & gate_ok, W)
    return keep, acc, cnt, sm, mn, mx


def _check(name, x, dtype, n, dev, ndim=1):
    if x.device != dev or x.dtype != dtype or x.dim() != ndim \
            or (n is not None and x.shape[0] != n) or not x.is_contiguous():
        raise KernelInputError(
            f"predicate_kernel: {name} must be a contiguous {dtype} tensor "
            f"of {ndim} dimension(s){'' if n is None else f' and length {n}'}"
            f" on {dev}; got {x.dtype} {tuple(x.shape)} on {x.device} "
            f"(contiguous={x.is_contiguous()})")


def _launch(table, feats, pair_pub, pair_pred, agg, acc, W: int):
    """The CUDA dispatch behind both wrappers: ``(keep, partials [4, W] or
    None)``. Only the outputs are allocated per call; the fold scratch is
    held (:func:`held_scratch`)."""
    global launches
    dev = feats.device
    p_op, p_field, p_a, p_b, p_mlo, p_mhi = table
    NP = p_op.shape[0]
    for name, x, dt in (("p_op", p_op, torch.int32),
                        ("p_field", p_field, torch.int32),
                        ("p_a", p_a, torch.float32),
                        ("p_b", p_b, torch.float32),
                        ("p_mlo", p_mlo, torch.int32),
                        ("p_mhi", p_mhi, torch.int32)):
        _check(name, x, dt, NP, dev)
    _check("feats", feats, torch.float32, None, dev, ndim=2)
    B, F = feats.shape
    P = pair_pub.shape[0]
    _check("pair_pub", pair_pub, torch.int32, P, dev)
    _check("pair_pred", pair_pred, torch.int32, P, dev)
    if NP <= 0 or B <= 0 or F <= 0:
        raise KernelInputError(
            f"predicate_kernel: needs a non-empty table and feature matrix; "
            f"got {NP} rows, feats {tuple(feats.shape)}")
    keep = torch.empty(P, dtype=torch.bool, device=dev)
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    A = 0
    a_ptrs = [None] * 5
    part = scratch = None
    if agg is not None:
        agg_slot, agg_pub, agg_field, agg_gate, agg_valid = agg
        A = agg_slot.shape[0]
        for name, x in (("agg_slot", agg_slot), ("agg_pub", agg_pub),
                        ("agg_field", agg_field), ("agg_gate", agg_gate)):
            _check(name, x, torch.int32, A, dev)
        _check("agg_valid", agg_valid, torch.bool, A, dev)
        _check("acc", acc, torch.float32, W, dev, ndim=2)
        if W <= 0 or acc.shape[1] != 4 or acc.data_ptr() % 16:
            raise KernelInputError(
                f"predicate_kernel: acc must be a 16-byte aligned [W, 4] "
                f"table with W > 0; got {tuple(acc.shape)}")
        a_ptrs = [ptr(x) for x in agg]
        part = torch.empty((4, W), dtype=torch.float32, device=dev)
    lib = _build.load("predicate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if agg is not None:
            scratch = held_scratch(dev, W, stream)
        rc = lib.predicate_phase_launch(
            *[ptr(x) for x in table], NP, ptr(feats), B, F, ptr(pair_pub),
            ptr(pair_pred), ptr(keep), P, *a_ptrs, A,
            ptr(acc) if agg is not None else None, W if agg is not None
            else 0, ptr(scratch), ptr(part), stream)
    if rc != 0:
        if agg is not None:  # the pass may have folded into it
            _scratch.pop((dev, stream, W), None)
        raise KernelError(f"predicate kernel launch failed: CUDA error {rc}")
    if P + A > 0 or agg is not None:
        launches += 1
    return keep, part


def _device_of(feats):
    dev = feats.device
    if dev.type not in ("cpu", "cuda"):
        raise KernelInputError(f"predicate_kernel: unsupported device {dev}")
    return dev


def eval_pairs(p_op, p_field, p_a, p_b, p_mlo, p_mhi, feats, pair_pub,
               pair_pred):
    """bool ``[P]`` keep verdicts of the pairs (the predicate-only dispatch:
    no aggregation folds in the batch)."""
    if _device_of(feats).type == "cpu":
        return eval_pairs_ref(p_op, p_field, p_a, p_b, p_mlo, p_mhi, feats,
                              pair_pub, pair_pred)
    keep, _ = _launch((p_op, p_field, p_a, p_b, p_mlo, p_mhi), feats,
                      pair_pub, pair_pred, None, None, 0)
    return keep


def predicate_phase(p_op, p_field, p_a, p_b, p_mlo, p_mhi, acc, feats,
                    pair_pub, pair_pred, agg_slot, agg_pub, agg_field,
                    agg_gate, agg_valid, *, W: int):
    """The whole phase in one dispatch: ``(keep [P], acc, cnt [W], sum [W],
    min [W], max [W])``. ``agg_gate`` is a predicate-row id gating each fold
    (``OP_TRUE``'s row gates nothing); ``acc [W, 4]`` (count, sum, min,
    max) is updated in place where the batch touched a slot."""
    if _device_of(feats).type == "cpu":
        return predicate_phase_ref(p_op, p_field, p_a, p_b, p_mlo, p_mhi,
                                   acc, feats, pair_pub, pair_pred, agg_slot,
                                   agg_pub, agg_field, agg_gate, agg_valid,
                                   W=W)
    keep, part = _launch((p_op, p_field, p_a, p_b, p_mlo, p_mhi), feats,
                         pair_pub, pair_pred,
                         (agg_slot, agg_pub, agg_field, agg_gate, agg_valid),
                         acc, W)
    return keep, acc, part[0], part[1], part[2], part[3]


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.predicate_phase_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 6 + [I] + [P] + [I, I] + [P] * 3 + [I] + [P] * 5 \
        + [I] + [P] + [I] + [P, P, P]
    fn.restype = ctypes.c_int


_build.register("predicate", _bind)
