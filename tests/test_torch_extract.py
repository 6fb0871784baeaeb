"""The extraction kernel's plain version and wrapper (ops/extract.py) on
the CPU, against the JAX reference's ``extract_indices_packed``.

Same-seed numpy masks go through the reference (jitted, blocks 512 and
2048) and through ``extract_rows_ref`` / ``extract_rows``; every comparison
is exact. The kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py); here the wrapper takes the plain version, and the launch
geometry it would hand the kernel is checked.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import n, t
from vernemq_tpu.ops import match_kernel as JK
from vernemq_tpu_torch.ops import extract as EX
from vernemq_tpu_torch.ops import match_kernel as TK
from vernemq_tpu_torch.ops import reverse_tiles as RT
from vernemq_tpu_torch.ops.tile_match import KernelInputError

_extract_ref = jax.jit(JK.extract_indices_packed, static_argnums=(1, 2))

R0, W = 16, 64          # 2048 columns: whole 512- and 2048-column blocks
K_PAST = 32 * W + 52    # k past every possible count


def _mask(seed, density, R=R0, cols=W * 32):
    """A ``[R, cols]`` bool mask at ``density`` with an empty first row and
    an all-ones last row, and its packed uint32 words (cols padded to 32)."""
    rng = np.random.default_rng(seed)
    m = rng.random((R, cols)) < density
    m[0] = False
    m[-1] = True
    pad = np.zeros((R, -cols % 32), bool)
    bits = np.concatenate([m, pad], axis=1).reshape(R, -1, 32)
    words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(axis=2).astype(np.uint32)
    return m, words


def _selection(seed, R):
    """Rows out of order and repeated, about a fifth of them dead."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, R, 3 * R).astype(np.int32)
    rows[:3] = [R - 1, 0, R - 1]
    ok = rng.random(rows.shape[0]) < 0.8
    ok[:2] = True
    ok[2] = False
    return rows, ok


def _want(jax_out, rows, ok):
    """The reference's per-row results gathered by ``rows``, dead rows
    zeroed (count 0, nothing valid)."""
    idx, valid, count = (np.asarray(x) for x in jax_out)
    return (idx[rows], valid[rows] & ok[:, None],
            np.where(ok, count[rows], 0))


def _same(got, want):
    gi, gv, gc = (n(x) for x in got)
    wi, wv, wc = want
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi[gv], wi[wv])
    assert not gi[~gv].any()  # 0 past the count, as the kernel writes


@pytest.mark.parametrize("density", [0.0, 0.001, 0.3, 1.0])
@pytest.mark.parametrize("k", [1, 16, K_PAST])
def test_plain_extraction_equals_the_reference(density, k):
    """Without counts, on selected rows out of order, repeated and dead:
    the reference's rows (blocks 512 and 2048) gathered, dead rows zeroed;
    and the ids where valid are the rows' set columns in order."""
    m, words = _mask(int(density * 1000) + k, density)
    rows, ok = _selection(k, R0)
    got = EX.extract_rows_ref(t(words.view(np.int32)), k, rows=t(rows),
                              ok=t(ok))
    for block in (512, 2048):
        _same(got, _want(_extract_ref(words, k, block), rows, ok))
    gi, gv, _ = (n(x) for x in got)
    for i in range(3):
        want = np.nonzero(m[rows[i]])[0][:k] if ok[i] else []
        np.testing.assert_array_equal(gi[i][gv[i]], want)


@pytest.mark.parametrize("k", [1, 16, K_PAST])
def test_counts_give_the_same_extraction(k):
    """With the chunk counts the retained compare kernel writes
    (``reverse_tiles.chunk_counts``), the plain version equals the
    counts-free one element for element."""
    _, words = _mask(k, 0.01)
    pt = t(words.view(np.int32))
    rows, ok = _selection(k + 1, R0)
    kw = dict(rows=t(rows), ok=t(ok))
    with_counts = EX.extract_rows_ref(pt, k, counts=RT.chunk_counts(pt),
                                      **kw)
    for g, w in zip(with_counts, EX.extract_rows_ref(pt, k, **kw)):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.parametrize("cols", [32, 61 * 32 - 7, 1029 * 32])
def test_ragged_width(cols):
    """Widths whose last 256-column chunk is short (61 and 1029 words) and
    one word: equal to the reference at one word a block, and to the set
    columns themselves; every row when ``rows`` and ``ok`` are None."""
    m, words = _mask(cols, 0.02, R=6, cols=cols)
    got = EX.extract_rows(t(words.view(np.int32)), 40)
    everyone = np.arange(6), np.ones(6, bool)
    _same(got, _want(_extract_ref(words, 40, 32), *everyone))
    gi, gv, gc = (n(x) for x in got)
    for r in range(6):
        np.testing.assert_array_equal(gi[r][gv[r]], np.nonzero(m[r])[0][:40])
    assert gc[-1] == cols


def test_wrapper_takes_the_plain_version_on_cpu_only():
    """On CPU tensors the wrapper returns the plain version's result and
    launches nothing (no plain extraction of a card tensor is counted); a
    tensor on another device, counts that are not the chunks of the mask,
    a wrong dtype or a non-positive k are refused."""
    _, words = _mask(5, 0.05)
    pt = t(words.view(np.int32))
    rows, ok = (t(x) for x in _selection(5, R0))
    before, plain = EX.launches, TK.plain_cuda_extractions
    got = EX.extract_rows(pt, 16, rows=rows, ok=ok)
    assert EX.launches == before and TK.plain_cuda_extractions == plain
    for g, w in zip(got, EX.extract_rows_ref(pt, 16, rows=rows, ok=ok)):
        assert torch.equal(g, w)
    meta = [x.to("meta") for x in (pt, rows, ok)]
    with pytest.raises(KernelInputError, match="unsupported device"):
        EX.extract_rows(meta[0], 16, rows=meta[1], ok=meta[2])
    counts = RT.chunk_counts(pt)
    with pytest.raises(KernelInputError, match="chunks of the packed"):
        EX.extract_rows(pt, 16, rows=rows, ok=ok, counts=counts[:, :3])
    with pytest.raises(KernelInputError, match="chunks of the packed"):
        RT.extract_chunks(pt, counts[:4], 16, rows=rows, ok=ok)
    with pytest.raises(KernelInputError, match="int32"):
        EX.extract_rows(pt, 16, rows=rows.long(), ok=ok)
    with pytest.raises(KernelInputError, match="bool"):
        EX.extract_rows(pt, 16, rows=rows, ok=ok.int())
    with pytest.raises(KernelInputError, match="k > 0"):
        EX.extract_rows(pt, 0, rows=rows, ok=ok)


# (rows, words a row, with counts, warps a row): the forward headline's
# probe A (4096 x 8192) and B and dense region 0, a broker-sized flush of
# probe A rows, a row too long to split without counts, few rows of few
# chunk groups, and the retained dense (224 rows of 4,136 chunks) and
# probe launches
SPLITS = [(4096, 8192, False, 1), (4096, 1024, False, 1),
          (4096, 64, False, 1), (32, 8192, False, 8), (32, 16384, False, 1),
          (300, 1024, False, 4), (224, 4136 * 8, True, 8),
          (4096, 64, True, 1)]


@pytest.mark.parametrize("R,W,with_counts,S", SPLITS)
def test_launch_geometry(R, W, with_counts, S):
    """The warps a launch gives each row: enough rows fill the card one
    warp a row; fewer long rows are split (the retained dense launch
    over 1,792 warps, not 224), and without counts only while a span fits
    the groups a warp holds in registers."""
    assert EX.split(R, W, with_counts) == S
    groups = -(-W // 256)
    if S > 1 and not with_counts:
        assert -(-groups // S) <= EX.GROUPS_IN_FLIGHT
