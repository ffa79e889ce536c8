"""K8's share of its bound: the frozen work of every launch in the
traced window (one a step, the whole batch), at the H100 SXM's published
peaks, over K8's device time (kernels/K8.json)."""


def read(tr):
    return tr.roofline("K8")
