"""Kernel B, box counting (``csrc/boxcount.cu``), on the card against its
plain version.

Every test here needs a CUDA device and skips without one.  On the card
(whose machine has no JAX, which ``tests/conftest.py`` imports):
``python -m pytest --noconftest -m cuda tests/test_torch_boxcount.py``.
The CPU tests of B's launch table are in ``tests/test_torch_length.py``.

Tolerance: the kernel's totals against the plain version on the same
float32 inputs, run in float64 and in float32, relative to the largest
total (``REL``).  Both test the same float32 values, so the crossed
(box, level) pairs are the same; the totals differ by the float32 sums of
up to ~10^5 positive weights in another order (the kernel: a lane's run
of a tile, the tile's groups, then the tiles in order).  At the T170 step
an H100 measured 3.2e-7 against both.
"""

import numpy as np
import pytest
import torch

import xcontour_tpu_torch as xt
from xcontour_tpu_torch import core
from xcontour_tpu_torch.diagnostics import length as dlength
from xcontour_tpu_torch.kernels import boxcount
from xcontour_tpu_torch.utils.synth import synth_pv

REL = 2e-6
T170_STRIDES = (1, 2, 4, 8, 16, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want):
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert scale > 0
    return float((got.double() - want.double()).abs().max()) / scale


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _case(dev, B, Ny, Nx, N, seed):
    v, _ = synth_pv(nlev=B, nlat=Ny, nlon=Nx, seed=seed)
    grid = xt.from_latlon(v["latitude"], v["longitude"], device=dev)
    q = torch.as_tensor(v["pv"]).to(dev)
    return q, core.cal_contours(q, N), grid.dA.to(torch.float32)


def _check(q, ctr, area, strides, mode="edge", quirks=False):
    """The kernel once (one launch), twice more for the bits, against the
    plain version in float64 and float32; returns (rel64, rel32)."""
    before = boxcount.KERNEL.launches
    got = dlength.box_counting_lengths(q, ctr, area, strides, mode=mode,
                                       quirks=quirks)
    assert boxcount.KERNEL.launches == before + 1
    again = dlength.box_counting_lengths(q, ctr, area, strides, mode=mode,
                                         quirks=quirks)
    assert _same_bits(got, again)
    pad = max(strides)
    d = dlength._pad_x(q, pad, mode)
    a = dlength._pad_x(area, pad, mode)
    rels = []
    for dt in (torch.float64, torch.float32):
        want = boxcount.box_counts_plain(d.to(dt), ctr.to(dt), a.to(dt),
                                         strides, quirks)
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        rels.append(_rel(got, want))
    return rels


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_t170_step(cuda):
    """The t170.fractal step: 32 x 256 x 512, N = 121, strides 1-32."""
    q, ctr, area = _case(cuda, 32, 256, 512, 121, 100)
    rel64, rel32 = _check(q, ctr, area, T170_STRIDES)
    assert rel64 <= REL and rel32 <= REL, (rel64, rel32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,quirks", [("edge", False), ("wrap", True),
                                         ("reflect", False),
                                         ("constant", True)])
def test_kernel_matches_plain_at_odd_shapes(cuda, mode, quirks):
    """Odd shapes, NaN data, areas and levels, unsorted levels, a 0-d
    level, the quirks form past the padded width (fuzz seed 1004's 11 x 8
    at stride 2)."""
    rng = np.random.default_rng(5)
    q, ctr, area = _case(cuda, 3, 41, 37, 9, 7)
    q[0, 5:9, 30:] = float("nan")
    area[2, 3] = float("nan")
    ctr = ctr[:, torch.as_tensor(rng.permutation(9), device=cuda)]
    ctr[1, 4] = float("nan")
    for strides in ([1], [3], [1, 3, 5, 2], [7]):
        rel64, rel32 = _check(q, ctr, area, strides, mode, quirks)
        assert rel64 <= REL and rel32 <= REL, (strides, rel64, rel32)
    _check(q, ctr[0, 3], area, [2], mode, quirks)
    f = torch.zeros((1, 11, 8), device=cuda)
    f[:, 5:] = 1.0
    lev = torch.tensor([0.5], device=cuda)
    got = xt.contour_crossing(f, lev, torch.full((11, 8), 4.0, device=cuda),
                              2, quirks=quirks)
    want = xt.contour_crossing(f.cpu().double(), lev.cpu().double(),
                               torch.full((11, 8), 4.0, dtype=torch.float64),
                               2, quirks=quirks)
    assert float(got[0, 0]) == float(want[0, 0])


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, ctr, area = _case(cuda, 2, 40, 36, 5, 3)
    with pytest.raises(TypeError, match="float32"):
        boxcount.box_counts(q.double(), ctr, area, [1])
    with pytest.raises(ValueError, match="no box of stride"):
        boxcount.box_counts(q, ctr, area, [40])
    with pytest.raises(ValueError, match="strides"):
        boxcount.box_counts(q, ctr, area, list(range(1, 34)))
