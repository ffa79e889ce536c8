"""K5's share of its bound: the frozen work of every launch in the
traced window (K3's count, ``lwa_work``), at the H100 SXM's published
peaks, over K5's device time (kernels/K5.json)."""


def read(tr):
    return tr.roofline("K5")
