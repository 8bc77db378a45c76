"""The least-time bounds `chip_smoke.py` sets beside each flash kernel's
time: the live (row, key) pairs of a padding mask inside the causal or
window band against a brute-force count, and the bytes each kernel must
move, which count q (and dO, O, LSE, delta) at live query rows only, and
every row in the dispatch's form (`all_rows`)."""

import numpy as np
import pytest

import chip_smoke

B, S, H, D = 5, 40, 3, 16
LENS = [40, 17, 1, 0, 33]


def _brute_pairs(lens, S, T, causal, window, all_rows):
    r, c = np.arange(S)[:, None], np.arange(T)[None, :]
    n = 0
    for L in lens:
        live = (c < L) & (np.ones((S, 1), bool) if all_rows else (r < L))
        if causal:
            live &= c <= r + T - S
        if window:
            live &= np.abs(r - c) <= window // 2
        n += int(live.sum())
    return n


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (False, 8), (True, 8)])
@pytest.mark.parametrize("all_rows", [False, True])
def test_live_pairs_match_a_brute_force_count(causal, window, all_rows):
    assert chip_smoke.live_pairs(LENS, S, S, causal, window, all_rows) == _brute_pairs(
        LENS, S, S, causal, window, all_rows)


@pytest.mark.parametrize("kernel,row_bytes", [("fwd", 2 * H * D), ("dq", 3 * 2 * H * D + 4 * H),
                                              ("dkv", 2 * 2 * H * D + 8 * H)])
def test_bound_bytes_read_live_query_rows_only(kernel, row_bytes):
    """A padded query row saves its reads (q, and for the backward dO, O,
    LSE, delta); outputs are written whole; all_rows reads every row."""
    def bound(**kw):
        if kernel == "fwd":
            return chip_smoke.attention_bound(B, S, S, H, H, D, **kw)
        return chip_smoke.backward_bound(kernel, B, S, S, H, H, D, **kw)

    padded_rows = B * S - sum(LENS)
    _, _, _, dense = bound(lens=[S] * B)
    _, _, _, live = bound(lens=LENS)
    _, _, _, every = bound(lens=LENS, all_rows=True)
    kv_saved = 2 * 2 * H * D * padded_rows  # k and v at padded keys
    assert every == dense - kv_saved
    assert live == every - row_bytes * padded_rows
    # no mask: every row and key, and no id vectors
    _, _, _, unmasked = bound()
    assert unmasked == dense - 4 * 2 * B * S
