"""The plain XLA sort, the merge of sorted runs and the weighted
run-length sum, against numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hysortk_tpu.ops import count as count_ops
from hysortk_tpu.ops import sort as sort_ops

FULL = np.uint32(0xFFFFFFFF)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 6])
def test_sort_keys_matches_lexsort(w):
    rng = np.random.default_rng(w)
    n = 4096
    # Few distinct high words so ties reach the later key words.
    words = [rng.integers(0, 4, n).astype(np.uint32)] + [
        rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        for _ in range(w - 1)
    ]
    invalid = (rng.random(n) < 0.2).astype(np.uint32)
    payload = np.arange(n, dtype=np.uint32)
    inv_s, words_s, (pay_s,) = jax.jit(sort_ops.sort_keys)(
        jnp.asarray(invalid), [jnp.asarray(x) for x in words],
        [jnp.asarray(payload)],
    )
    marked = [np.where(invalid == 1, FULL, x) for x in words]
    order = np.lexsort(tuple(reversed(marked)))
    for got, want in zip(words_s, marked):
        assert np.array_equal(np.asarray(got), want[order])
    n_valid = int((invalid == 0).sum())
    assert np.array_equal(np.asarray(inv_s), np.r_[np.zeros(n_valid), np.ones(n - n_valid)])
    # Payloads travel with their keys (ties may come in any order).
    pay_s = np.asarray(pay_s)
    for got, x in zip(words_s, marked):
        assert np.array_equal(np.asarray(got), x[pay_s])
    assert np.array_equal(np.sort(pay_s), payload)


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("s", [2, 4, 8])
def test_merge_sorted_runs_matches_lexsort(s, w):
    """The merge of sorted, sentinel-padded runs (as the range exchange's
    receive side and the streaming consolidation hold them) with a count
    payload, against numpy."""
    rng = np.random.default_rng(10 * s + w)
    run_len = 256
    n = s * run_len
    words = [rng.integers(0, 8, n).astype(np.uint32) for _ in range(w)]
    tail = np.zeros(n, bool)
    for r in range(s):
        cut = int(rng.integers(0, run_len + 1))
        tail[r * run_len + cut : (r + 1) * run_len] = True
    words = [np.where(tail, FULL, x) for x in words]
    for r in range(s):
        sl = slice(r * run_len, (r + 1) * run_len)
        order = np.lexsort(tuple(x[sl] for x in reversed(words)))
        words = [np.concatenate([x[: sl.start], x[sl][order], x[sl.stop :]])
                 for x in words]
    tail = words[0] == FULL
    for x in words[1:]:
        tail &= x == FULL
    payload = np.arange(n, dtype=np.uint32)
    inv, merged, (pay,) = jax.jit(sort_ops.sort_marked)(
        [jnp.asarray(x) for x in words], [jnp.asarray(payload)]
    )
    order = np.lexsort(tuple(reversed(words)))
    for got, x in zip(merged, words):
        assert np.array_equal(np.asarray(got), x[order])
    assert np.array_equal(np.asarray(inv), tail[order].astype(np.uint32))
    pay = np.asarray(pay)
    assert np.array_equal(np.sort(pay), np.arange(n))
    for got, x in zip(merged, words):
        assert np.array_equal(np.asarray(got), x[pay])


def _run_sums_numpy(words, weights):
    words = np.stack(words, -1)
    valid = ~(words == FULL).all(-1)
    head = np.zeros(len(words), bool)
    sums = np.zeros(len(words), np.int64)
    i = 0
    while i < len(words):
        j = i
        while j < len(words) and (words[j] == words[i]).all():
            j += 1
        if valid[i]:
            head[i] = True
            sums[i] = weights[i:j][valid[i:j]].sum()
        i = j
    return head, sums


@pytest.mark.parametrize(
    "case",
    ["all_invalid", "one_run", "all_distinct", "zero_weights",
     "large_weights", "runs_into_tail"],
)
def test_run_length_sum_edge_cases(case):
    rng = np.random.default_rng(len(case))
    n = 64
    if case == "all_invalid":
        keys = np.full(n, FULL)
    elif case == "one_run":
        keys = np.full(n, 7, np.uint32)
    elif case == "all_distinct":
        keys = np.arange(n, dtype=np.uint32)
    else:
        keys = np.sort(rng.integers(0, 12, n).astype(np.uint32))
        if case == "runs_into_tail":
            keys[-10:] = FULL
    weights = {
        "zero_weights": np.zeros(n, np.int32),
        "large_weights": np.full(n, 2**24, np.int32),
    }.get(case, rng.integers(1, 100, n).astype(np.int32))
    words = [keys, np.zeros(n, np.uint32)]
    words[1][keys == FULL] = FULL
    svalid = sort_ops.sentinel_valid([jnp.asarray(x) for x in words])
    head, total = count_ops.run_length_sum(
        svalid, [jnp.asarray(x) for x in words], jnp.asarray(weights)
    )
    want_head, want_sum = _run_sums_numpy(words, weights)
    assert np.array_equal(np.asarray(head), want_head)
    assert np.array_equal(np.asarray(total), np.where(want_head, want_sum, 0))
