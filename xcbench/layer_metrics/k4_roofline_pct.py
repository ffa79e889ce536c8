"""K4's share of its bound: the frozen work of every launch in the
traced window (K3's count, ``lwa_work``: every (surface, cell) pair at 3
instructions, whatever part a launch sums), at the H100 SXM's published
peaks, over K4's device time (kernels/K4.json)."""


def read(tr):
    return tr.roofline("K4")
