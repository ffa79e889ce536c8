"""K3's share of its bound: the frozen work of every launch in the
traced window, at the H100 SXM's published peaks, over K3's device time
(kernels/K3.json)."""


def read(tr):
    return tr.roofline("K3")
