"""K7-K8: marching-squares contour lengths (CUDA: ``csrc/length.cu``).

K7 (:func:`contour_lengths`) replaces ``_kernel`` of
``xcontour_tpu/kernels/length_pallas.py`` (launched by
``contour_lengths_pallas``): the total perimeter of each level of each batch
element, skimage 'low' saddles, haversine (radians, unit sphere) or hypot
lengths, no segment in a cell with a NaN corner, 0 for an empty contour.
Its plain version is the XLA twin ``_lengths_totals_xla``.

K8 (:func:`local_lengths`) replaces ``_local_kernel`` of the same file
(launched by ``local_lengths_pallas``): the length inside each window of a
2-D field, or of each field of a batch in one launch, at that window's own
level.  Its plain version is ``_local_totals_xla_raw`` of
``diagnostics/local_length.py``, a field at a time.

Both follow the twin's tie rule: edge fractions by division and vertices
that land bitwise on a corner at a fraction of 0 or 1, so a level equal to
the field's minimum totals exactly 0.  A NaN level is evaluated at 0 and
its total set to 0; the public functions turn a 0 total into NaN.

Both kernels measure only the crossed (cell, level) pairs, a warp's 32
lanes at a time: a level crosses a valid cell exactly when it lies in
[min, max) of the cell's corners.  K7 finds each cell's range of sorted
levels by search inside tiles of ``TILE`` cells; K8 tests each block of
stride x stride cells on the windows' lattice (:func:`lattice`) against
the levels of the windows that cover it.  Both sum in 64-bit fixed point
by integer atomics, so two runs agree bit for bit.
``tests/test_torch_length_tiles.py`` emulates both decompositions.
"""

from __future__ import annotations

import torch

from . import Kernel, check_cuda_inputs, check_status, stream_handle, vjp

KERNEL_LENGTHS = Kernel("contour_lengths", "xcontour_tpu_torch/csrc/length.cu",
                        "xcontour_tpu/kernels/length_pallas.py:188")
KERNEL_LOCAL_LENGTHS = Kernel("local_lengths",
                              "xcontour_tpu_torch/csrc/length.cu",
                              "xcontour_tpu/kernels/length_pallas.py:417")

# K7's tile of cells (csrc/length.cu kRB x kCB), the unit of its level pretest
TILE = (16, 128)


def _level_total(level, v00, v01, v10, v11, y0, y1, x0, x1, nan_cell,
                 latlon: bool):
    """The twin's ``_level_total_length``: summed in-cell segment lengths
    of each level over the last two axes.  NaN corners are zeroed before
    classification and their cells dropped."""
    zero = torch.zeros((), dtype=v00.dtype, device=v00.device)
    v00, v01, v10, v11 = (torch.where(nan_cell, zero, v)
                          for v in (v00, v01, v10, v11))
    a00, a01, a10, a11 = (v > level for v in (v00, v01, v10, v11))

    def frac(va, vb):
        d = vb - va
        return torch.where(d == 0, zero,
                           (level - va) / torch.where(d == 0, zero + 1, d))

    def lerp(f, c0, c1):
        # the convex combination: f = 0 or 1 lands bitwise on a corner
        return (1.0 - f) * c0 + f * c1

    top = (y0, lerp(frac(v00, v01), x0, x1))
    bot = (y1, lerp(frac(v10, v11), x0, x1))
    lef = (lerp(frac(v00, v10), y0, y1), x0)
    rig = (lerp(frac(v01, v11), y0, y1), x1)

    def seglen(p, q):
        # the twin's grad-safe forms (_hypot_grad_safe, _haversine): the
        # zero-length segments that levels pinned to a field's extrema make
        # through cell corners have 0/0 jacobians, so those lanes (and the
        # antipodal a == 1) take their exact primal as a constant through
        # a substituted argument, and the zero subgradient
        if not latlon:
            d0, d1 = p[0] - q[0], p[1] - q[1]
            deg = (d0 == 0) & (d1 == 0)
            one = zero + 1
            return torch.where(deg, zero,
                               torch.hypot(torch.where(deg, one, d0),
                                           torch.where(deg, one, d1)))
        a = (torch.sin((q[0] - p[0]) * 0.5) ** 2
             + torch.cos(p[0]) * torch.cos(q[0])
             * torch.sin((q[1] - p[1]) * 0.5) ** 2)
        a = torch.clamp(a, 0.0, 1.0)
        bad = (a == 0) | (a == 1)
        core = 2.0 * torch.arcsin(torch.sqrt(torch.where(bad, zero + 0.25,
                                                         a)))
        return torch.where(bad, torch.where(a == 0, zero, zero + torch.pi),
                           core)

    def sel(c, p, q):
        return (torch.where(c, p[0], q[0]), torch.where(c, p[1], q[1]))

    iso00 = (a00 != a01) & (a00 != a10) & (a01 == a11)
    iso01 = (a01 != a00) & (a01 != a11) & (a00 == a10)
    iso10 = (a10 != a00) & (a10 != a11) & (a00 == a01)
    iso11 = (a11 != a01) & (a11 != a10) & (a01 == a00)
    horiz = (a00 == a01) & (a10 == a11) & (a00 != a10)
    verti = (a00 == a10) & (a01 == a11) & (a00 != a01)
    sad_main = a00 & a11 & ~a01 & ~a10
    sad_anti = a01 & a10 & ~a00 & ~a11

    p1 = sel(horiz, lef, sel(iso10 | iso11, bot, top))
    q1 = sel(iso00 | iso10 | sad_main, lef, sel(verti, bot, rig))
    exists1 = iso00 | iso01 | iso10 | iso11 | horiz | verti | sad_main | sad_anti
    L = torch.where(exists1, seglen(p1, q1), zero)
    L = L + torch.where(sad_main | sad_anti, seglen(bot, sel(sad_main, rig, lef)),
                        zero)
    return torch.where(nan_cell, zero, L).sum(dim=(-2, -1))


def _per_batch(c: torch.Tensor, B: int) -> torch.Tensor:
    return torch.broadcast_to(c, (B, c.shape[-1]))


def contour_lengths_plain(data: torch.Tensor, levels: torch.Tensor,
                          yc: torch.Tensor, xc: torch.Tensor, *, latlon: bool,
                          chunk: int = 8) -> torch.Tensor:
    """data (B, Ny, Nx); levels (B, N); yc (Ny,) or (B, Ny); xc (Nx,) or
    (B, Nx) -> (B, N) raw totals, ``chunk`` levels at a time."""
    B = data.shape[0]
    N = levels.shape[-1]
    y = _per_batch(yc, B)[:, None, :, None]               # (B, 1, Ny, 1)
    x = _per_batch(xc, B)[:, None, None, :]               # (B, 1, 1, Nx)
    d = data[:, None]
    v00, v01 = d[..., :-1, :-1], d[..., :-1, 1:]
    v10, v11 = d[..., 1:, :-1], d[..., 1:, 1:]
    nan_cell = (torch.isnan(v00) | torch.isnan(v01) | torch.isnan(v10)
                | torch.isnan(v11))
    y0, y1 = y[..., :-1, :], y[..., 1:, :]
    x0, x1 = x[..., :-1], x[..., 1:]
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    outs = []
    for k in range(0, N, max(1, chunk)):
        lev = levels[:, k:k + chunk]
        nan_lev = torch.isnan(lev)
        ls = torch.where(nan_lev, zero, lev)[..., None, None]
        tot = _level_total(ls, v00, v01, v10, v11, y0, y1, x0, x1, nan_cell,
                           latlon)
        outs.append(torch.where(nan_lev, zero, tot))
    if not outs:
        return levels.new_zeros((B, 0))
    return torch.cat(outs, dim=-1)


# the most (batch element, level, cell) triples one level chunk of the
# plain versions' VJP recomputes: its temporaries are ~80 tensors of this
# size (64 MB each in float32), whatever the batch
VJP_TRIPLES = 1 << 24


def contour_lengths_vjp(data, levels, yc, xc, g, needs, *, latlon: bool,
                        chunk: int = 8):
    """Cotangents of (data, levels, yc, xc) of :func:`contour_lengths_plain`
    for the cotangent g (B, N), a chunk of levels at a time: at most
    ``chunk`` levels, fewer where B x levels x cells would pass
    ``VJP_TRIPLES``."""
    B, N = levels.shape
    cells = data.shape[-2] * data.shape[-1]
    step = max(1, min(chunk, VJP_TRIPLES // max(1, B * cells)))

    def piece(k):
        return lambda p: contour_lengths_plain(
            p[0], p[1][:, k:k + step], p[2], p[3], latlon=latlon, chunk=step)
    pieces = [(piece(k), g[:, k:k + step]) for k in range(0, N, step)]
    return vjp(pieces, (data, levels, yc, xc), needs)


def _check_coords(name, c, B, n, what):
    if c.dim() not in (1, 2) or c.shape[-1] != n or \
            (c.dim() == 2 and c.shape[0] != B):
        raise ValueError(f"{name}: {what} must be ({n},) or ({B}, {n}), "
                         f"got {tuple(c.shape)}")


def contour_lengths(data: torch.Tensor, levels: torch.Tensor,
                    yc: torch.Tensor, xc: torch.Tensor, *, latlon: bool,
                    chunk: int = 8) -> torch.Tensor:
    """Raw perimeter totals (B, N) of data (B, Ny, Nx) at levels (B, N);
    coordinates shared, (Ny,)/(Nx,), or per batch element, (B, Ny)/(B, Nx),
    in radians if ``latlon``.  CPU tensors take the plain version (``chunk``
    levels at a time); CUDA tensors launch K7 (tiles that find their own
    and each cell's range of sorted levels and measure the crossed pairs):
    any batch, any number of levels, fewer than 2^31 cells (32-bit row
    offsets)."""
    if data.device.type == "cpu":
        return contour_lengths_plain(data, levels, yc, xc, latlon=latlon,
                                     chunk=chunk)
    name = KERNEL_LENGTHS.name
    check_cuda_inputs(name, data=data, levels=levels, yc=yc, xc=xc)
    if data.dim() != 3 or levels.dim() != 2:
        raise ValueError(f"{name}: expected data (B, Ny, Nx), levels (B, N)")
    B, Ny, Nx = data.shape
    N = levels.shape[1]
    if levels.shape[0] != B:
        raise ValueError(f"{name}: levels {tuple(levels.shape)} do not match "
                         f"{B} batch elements")
    _check_coords(name, yc, B, Ny, "yc")
    _check_coords(name, xc, B, Nx, "xc")
    if Ny < 2 or Nx < 2:
        raise ValueError(f"{name}: need Ny, Nx >= 2")
    if data.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 cells")
    if B == 0 or N == 0:
        return levels.new_zeros((B, N))
    from ._build import library
    lev_s, order = torch.sort(levels, dim=-1, stable=True)   # NaN last
    n_rb, n_cb = -(-(Ny - 1) // TILE[0]), -(-(Nx - 1) // TILE[1])
    # the totals in 64-bit fixed point, then the scale's word
    acc = torch.empty((B * N + 1,), dtype=torch.int64, device=data.device)
    out = torch.empty((B, N), dtype=data.dtype, device=data.device)
    status = library().xc_contour_lengths(
        data.data_ptr(), lev_s.data_ptr(), order.data_ptr(), yc.data_ptr(),
        xc.data_ptr(), acc.data_ptr(), out.data_ptr(), B, Ny, Nx, N, n_rb,
        n_cb, int(yc.dim() == 2), int(xc.dim() == 2), int(latlon),
        stream_handle())
    check_status(name, status)
    KERNEL_LENGTHS.count()
    return out


def _anchors(n: int, window: int, stride: int) -> range:
    return range(0, n - window + 1, stride)


def lattice(Wy: int, Wx: int, window: int, stride: int):
    """(nby, nbx, nbw) of K8's pretest: the blocks of stride x stride
    cells from the field's corner that the windows cover (nby x nbx), and
    the blocks a side of one window (nbw; the window's last block row and
    column may be covered in part, and past a window of fewer cells than
    the stride a block's last rows and columns lie in no window)."""
    nbw = (window - 2) // stride + 1 if window > 1 else 0
    return Wy - 1 + nbw, Wx - 1 + nbw, nbw


def local_lengths_plain(data: torch.Tensor, levels: torch.Tensor,
                        yc: torch.Tensor, xc: torch.Tensor, *, window: int,
                        stride: int, latlon: bool) -> torch.Tensor:
    """data (Ny, Nx) or (B, Ny, Nx); levels (Wy, Wx) or (B, Wy, Wx) ->
    raw window totals of levels' shape: a field at a time, one row of
    windows at a time through :func:`contour_lengths_plain`, each window a
    batch element with its own x coordinates."""
    if data.dim() == 3:
        if data.shape[0] == 0:
            return levels.new_zeros(levels.shape)
        return torch.stack([local_lengths_plain(d, lv, yc, xc, window=window,
                                                stride=stride, latlon=latlon)
                            for d, lv in zip(data, levels)])
    Ny, Nx = data.shape
    oy = _anchors(Ny, window, stride)
    Wx = len(_anchors(Nx, window, stride))
    if len(oy) == 0 or Wx == 0:
        return levels.new_zeros((len(oy), Wx))
    return torch.cat([_window_rows(data, levels, yc, xc, slice(iy, iy + 1),
                                   window, stride, latlon)
                      for iy in range(len(oy))])


def _window_rows(data, levels, yc, xc, rows: slice, window: int, stride: int,
                 latlon: bool):
    """Raw totals (k, Wx) of the k window rows ``rows``: each window a
    batch element of :func:`contour_lengths_plain` with its own y and x
    coordinates."""
    k = rows.stop - rows.start
    y0 = rows.start * stride
    span = slice(y0, y0 + (k - 1) * stride + window)
    patches = data[span].unfold(0, window, stride).unfold(1, window, stride)
    Wx = patches.shape[1]                          # (k, Wx, window, window)
    ywin = yc[span].unfold(0, window, stride)[:, None]
    xwin = xc.unfold(0, window, stride)[None]
    return contour_lengths_plain(
        patches.reshape(k * Wx, window, window),
        levels[rows].reshape(k * Wx, 1),
        ywin.expand(k, Wx, window).reshape(k * Wx, window),
        xwin.expand(k, Wx, window).reshape(k * Wx, window),
        latlon=latlon)[:, 0].reshape(k, Wx)


def local_lengths_vjp(data, levels, yc, xc, g, needs, *, window: int,
                      stride: int, latlon: bool):
    """Cotangents of (data, levels, yc, xc) of :func:`local_lengths_plain`
    for the cotangent g (levels' shape), a field and a chunk of window rows
    at a time: as many rows as keep (windows x cells) within
    ``VJP_TRIPLES``."""
    Wy, Wx = levels.shape[-2:]
    step = max(1, VJP_TRIPLES // max(1, Wx * (window - 1) ** 2))

    def piece(b, rows):
        if b is None:
            return lambda p: _window_rows(*p, rows, window, stride, latlon)
        return lambda p: _window_rows(p[0][b], p[1][b], p[2], p[3], rows,
                                      window, stride, latlon)
    fields = [None] if data.dim() == 2 else range(data.shape[0])
    pieces = [(piece(b, slice(i, min(Wy, i + step))),
               (g if b is None else g[b])[i:i + step])
              for b in fields for i in range(0, Wy, step)]
    return vjp(pieces, (data, levels, yc, xc), needs)


def local_lengths(data: torch.Tensor, levels: torch.Tensor, yc: torch.Tensor,
                  xc: torch.Tensor, *, window: int, stride: int,
                  latlon: bool) -> torch.Tensor:
    """Raw length inside each window of ``window`` x ``window`` points of
    data (Ny, Nx), anchored every ``stride`` points, at that window's level
    (Wy, Wx); or of each field of data (B, Ny, Nx) at levels (B, Wy, Wx).
    Coordinates (Ny,), (Nx,), radians if ``latlon``.  Returns levels'
    shape.  CPU tensors take the plain version; CUDA tensors launch K8 once
    a call, batch or not, up to 65,535 fields a launch (a warp per lattice
    block of a field, testing the levels of the windows that cover it
    against its corner range, measuring the crossed cells; each field's
    totals are the bits of a launch on it alone): any window >= 1 and
    stride >= 1, fewer than 2^31 cells."""
    if data.device.type == "cpu":
        return local_lengths_plain(data, levels, yc, xc, window=window,
                                   stride=stride, latlon=latlon)
    name = KERNEL_LOCAL_LENGTHS.name
    check_cuda_inputs(name, data=data, levels=levels, yc=yc, xc=xc)
    if data.dim() not in (2, 3):
        raise ValueError(f"{name}: data must be (Ny, Nx) or (B, Ny, Nx)")
    B = data.shape[0] if data.dim() == 3 else 1
    Ny, Nx = data.shape[-2:]
    Wy = len(_anchors(Ny, window, stride))
    Wx = len(_anchors(Nx, window, stride))
    want = data.shape[:-2] + (Wy, Wx)
    if levels.shape != want:
        raise ValueError(f"{name}: levels {tuple(levels.shape)}, expected "
                         f"{tuple(want)}")
    if yc.shape != (Ny,) or xc.shape != (Nx,):
        raise ValueError(f"{name}: coordinates {tuple(yc.shape)}, "
                         f"{tuple(xc.shape)} do not match ({Ny}, {Nx})")
    if window < 1 or stride < 1:
        raise ValueError(f"{name}: window and stride must be >= 1")
    if data.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 cells")
    if B == 0 or Wy == 0 or Wx == 0:
        return levels.new_zeros(want)
    from ._build import library
    nby, nbx, nbw = lattice(Wy, Wx, window, stride)
    # the windows' totals in 64-bit fixed point, then the scale's word
    acc = torch.empty((B * Wy * Wx + 1,), dtype=torch.int64,
                      device=data.device)
    out = torch.empty(want, dtype=data.dtype, device=data.device)
    status = library().xc_local_lengths(
        data.data_ptr(), levels.data_ptr(), yc.data_ptr(), xc.data_ptr(),
        acc.data_ptr(), out.data_ptr(), B, Ny, Nx, Wy, Wx, window, stride,
        nby, nbx, nbw, int(latlon), stream_handle())
    check_status(name, status)
    KERNEL_LOCAL_LENGTHS.count()
    return out
