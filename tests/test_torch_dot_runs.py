"""The band products' run table (P2c-P2e on the card).

``bucket_dot.dot_runs`` cuts the blocks into maximal runs of one bucket
(npair: of block pairs, block ``b`` keyed by ``bucket_ids[b & ~1]``, over
the even count of blocks), longest first, then (0, 0) rows: the tensor-
core kernels' work units. Held here, on the CPU, against a NumPy walk of
the blocks: exp_dot's layout (its check and full scale), ragged runs with
unvisited buckets, an odd block count, one bucket, one block a bucket,
no blocks; the drivers build it once, and the wrappers check a caller's
table on the CPU too (the plain versions ignore it).
"""

import numpy as np
import pytest
import torch

from ska_sdp_func_torch.kernels import bucket_dot as bd
from ska_sdp_func_torch.utility.errors import SdpDataTypeError, SdpShapeError


def runs_numpy(ids, pair=False):
    """Reference: keys per block, cut where the key changes, sort by
    length (descending), then first block; pad with (0, 0) to the keys'
    count."""
    ids = np.asarray(ids)
    if pair:
        nb = len(ids) - len(ids) % 2
        ids = ids[np.arange(nb) & ~1]
    runs, start = [], 0
    for b in range(1, len(ids) + 1):
        if b == len(ids) or ids[b] != ids[b - 1]:
            runs.append((start, b - start))
            start = b
    if not len(ids):
        runs = []
    runs.sort(key=lambda r: (-r[1], r[0]))
    runs += [(0, 0)] * (len(ids) - len(runs))
    return np.asarray(runs, np.int32).reshape(-1, 2)


CASES = {
    "exp_dot_check": np.arange(8) // 2,
    "exp_dot": np.arange(2048) // 8,
    # Runs of 3, 1, 9 and 2 blocks; buckets 1, 4 and 6 unvisited.
    "ragged": np.repeat([0, 2, 3, 5], [3, 1, 9, 2]),
    "ragged_odd": np.repeat([0, 2, 3, 5], [3, 1, 9, 3]),
    "one_bucket": np.full(13, 4),
    "one_block_each": np.arange(11) * 2,
    "empty": np.zeros(0, np.int64),
}


@pytest.mark.parametrize("pair", [False, True], ids=["blocks", "pairs"])
@pytest.mark.parametrize("case", list(CASES))
def test_dot_runs_match_numpy(case, pair):
    ids = CASES[case]
    got = bd.dot_runs(torch.as_tensor(ids.astype(np.int32)), pair=pair)
    assert got.dtype == torch.int32 and got.is_contiguous()
    want = runs_numpy(ids, pair)
    np.testing.assert_array_equal(got.numpy(), want)
    # Every block taken (npair: the even count) lies in exactly one run.
    nb = len(ids) - (len(ids) % 2 if pair else 0)
    cover = np.zeros(nb, int)
    for first, count in got.numpy():
        cover[first:first + count] += 1
    assert (cover == 1).all()


def test_pair_runs_start_on_even_blocks():
    """npair's units hold whole pairs: every run starts on an even block
    and has an even count."""
    runs = bd.dot_runs(torch.as_tensor(CASES["ragged_odd"].astype(np.int32)),
                       pair=True).numpy()
    live = runs[runs[:, 1] > 0]
    assert (live[:, 0] % 2 == 0).all() and (live[:, 1] % 2 == 0).all()


@pytest.mark.parametrize("name", ["exp_dot", "exp_parity"])
def test_drivers_build_the_run_tables_once(name):
    from ska_sdp_func_torch.experiments import exp_dot, exp_parity

    drv = {"exp_dot": exp_dot, "exp_parity": exp_parity}[name]
    ops = drv.operands("cpu", check=True)
    np.testing.assert_array_equal(ops["runs"].numpy(),
                                  runs_numpy(ops["ids"].numpy()))
    if name == "exp_dot":
        np.testing.assert_array_equal(ops["pair_runs"].numpy(),
                                      runs_numpy(ops["ids"].numpy(), True))


def _ops():
    rng = np.random.default_rng(3)
    ids = CASES["ragged"].astype(np.int32)
    total = 128 * ids.size
    f = lambda *s: torch.as_tensor(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return torch.as_tensor(ids), (f(16, total), f(total, 128), f(8, total))


def test_wrappers_take_runs_on_cpu():
    """The plain versions ignore the table: with and without it the
    outputs are equal."""
    ids, ins = _ops()
    runs = bd.dot_runs(ids)
    for form in ("prod", "npair"):
        with_runs = bd.bucket_dot(form, ids, ins, 6, 128,
                                  runs=bd.dot_runs(ids, form == "npair"))
        assert torch.equal(with_runs, bd.bucket_dot(form, ids, ins, 6, 128))
    got = bd.grid_parity(ids, *ins, 6, 128, 4, 128, 4, runs=runs)
    assert torch.equal(got, bd.grid_parity(ids, *ins, 6, 128, 4, 128, 4))


def test_wrappers_reject_malformed_runs():
    ids, ins = _ops()
    runs = bd.dot_runs(ids)
    with pytest.raises(SdpShapeError):
        bd.bucket_dot("prod", ids, ins, 6, 128, runs=runs[:, :1])
    with pytest.raises(SdpDataTypeError):
        bd.bucket_dot("prod", ids, ins, 6, 128, runs=runs.long())
    with pytest.raises(SdpShapeError):
        bd.grid_parity(ids, *ins, 6, 128, 4, 128, 2, runs=runs.view(-1))
