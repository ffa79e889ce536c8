"""K2's share of its bound: the frozen work of every launch in the
traced window, at the H100 SXM's published peaks, over K2's device time
(kernels/K2.json)."""


def read(tr):
    return tr.roofline("K2")
