"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, one number per output key.

A key's number is its widest gap, max |program - reference| over the
reference's largest magnitude, over the elements both give finite.  An
element finite on one side only counts as a gap of ``MISMATCH`` (the whole
scale): a NaN where a value is due is wrong; so does an output of
another shape.  Three rules from the reference's own outputs, never from
the program's:

- ``amplified`` keys are compared on the contours that enclose, and leave
  out, at least ``extreme_area`` of the whole area (by the reference's
  ``intArea``): on the few outermost contours of a field the float order
  of a sum over a million cells alone decides Y_eq, and through it Lmin,
  the d/dA terms and Keff;
- ``coarsened`` keys (contour lengths on a ladder of coarsenings and the
  log-log slopes D and D_bc) are compared on the contours whose reference length is
  finite at every stride and at least ``vanish`` of its length at stride
  1: a level within rounding of a coarsened field's extreme draws a
  contour of a few metres on one side and none on the other, and a
  vanishing length swings the slope by its nature (see PERF.md);
- a key with a ``threshold`` (Keff, NaN from a value up) is compared with
  both sides clipped there, the reference's unclipped value standing in
  its NaN's place, so that a value at the threshold may be NaN on one side
  only and no more.
"""

from __future__ import annotations

import torch

MISMATCH = 1.0


def _selection(spec: dict, ref: dict):
    area = ref["intArea"].double()
    top = area[..., -1:]
    return torch.minimum(area, top - area) >= spec["extreme_area"] * top


def _lasting(spec: dict, ref: dict):
    L = ref["lengths"].double()
    return (torch.isfinite(L) & (L >= spec["vanish"] * L[..., :1])).all(-1)


def key_gap(got: torch.Tensor, want: torch.Tensor, sel=None,
            threshold=None, want_raw=None) -> float:
    got = got.to(want.device).double()
    want = want.double()
    if got.shape != want.shape:
        return MISMATCH
    if threshold is not None:
        raw = want_raw.double()
        masked = torch.isnan(got) & torch.isfinite(raw)
        got = torch.where(masked, threshold, got.clamp(max=threshold))
        want = torch.where(torch.isfinite(raw), raw.clamp(max=threshold),
                           want)
    if sel is None:
        sel = torch.ones_like(want, dtype=torch.bool)
    else:
        while sel.dim() < want.dim():
            sel = sel[..., None]
        sel = torch.broadcast_to(sel, want.shape)
    fg, fw = torch.isfinite(got) & sel, torch.isfinite(want) & sel
    both = fg & fw
    if not fw.any():
        return MISMATCH if bool(fg.any()) else 0.0
    scale = want[fw].abs().max()
    scale = scale if scale > 0 else torch.ones_like(scale)
    rel = torch.where(both, (got - want).abs() / scale, 0.0)
    rel = torch.where(fg != fw, MISMATCH, rel)[fg | fw]
    return float(rel.max())


def gaps(got: dict, want: dict, spec: dict) -> dict:
    """Each compared key's gap (``spec``: the cell's ``compare`` entry)."""
    rules = [(spec.get("amplified", ()), _selection),
             (spec.get("coarsened", ()), _lasting)]
    rules = [(keys, rule(spec, want)) for keys, rule in rules if keys]
    thresholds = spec.get("thresholds", {})
    out = {}
    for key in spec["keys"]:
        sel = None
        for keys, mask in rules:
            if key in keys:
                sel = mask if sel is None else sel & mask
        t = thresholds.get(key)
        out[key] = key_gap(got[key], want[key], sel, t,
                           want.get(key + "_raw") if t is not None else None)
    return out


def worst(readings) -> dict:
    """Key by key, the largest of several samples' gaps."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
