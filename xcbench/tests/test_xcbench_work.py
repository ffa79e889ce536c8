"""The frozen roofline arithmetic against counts made by hand."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from xcbench import roofline_work as rw  # noqa: E402


def test_lwa_work():
    # q and the field (2 x 2*3*4), W (3*4), Q (2*3): 4 bytes each;
    # 3 instructions per (surface, cell) pair: 2 * 3 * 3 * 4
    assert rw.lwa_work(2, 3, 4) == (4 * (48 + 12 + 6), 216)
    assert rw.lwa_work(2, 3, 4, pairs=10) == (4 * 66, 30)


def test_stencil_and_cdf_work():
    assert rw.stencil_work(2, 3, 4) == (4 * (48 + 12 + 3), 144)
    # values (2x5), 3 channels of weights (2x3x5), 2 x 5 edges, 2x3x4 out
    assert rw.cdf_work(2, 5, 4, 3) == (4 * (10 + 30 + 10 + 24), 30)


def test_bound_ms_picks_the_larger_time():
    t, by = rw.bound_ms((3.35e9, 1.0))
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = rw.bound_ms((1.0, 33.5e9))
    assert by == "operations" and t == pytest.approx(1.0)


def test_crossed_pairs_by_hand():
    # one 2x3 field: cells [[0,1],[2,3]] -> ranges [0,3), [1,4) for the
    # two cells; level 0.5 crosses cell 1 only, 1.5 and 2.5 cross both,
    # 3.5 crosses cell 2 only, 4 crosses none
    q = torch.tensor([[[0., 1., 2.], [2., 3., 4.]]])
    lev = torch.tensor([[0.5, 1.5, 2.5, 3.5, 4.0]])
    assert rw.k7_crossed_pairs(q, lev) == 1 + 2 + 2 + 1
    q[0, 0, 0] = float("nan")          # the first cell drops out
    assert rw.k7_crossed_pairs(q, lev) == 0 + 1 + 1 + 1
    nbytes, ops = rw.k7_work(q, lev, torch.zeros(2), torch.zeros(3), True)
    assert nbytes == 4 * (6 + 5 + 5 + 2 + 3)
    assert ops == rw.CLASSIFY_INSTR * 6 + rw.SEGMENT_INSTR[True] * 3
