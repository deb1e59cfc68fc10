"""shuffle_gbps.terasort (GB/s, host clock), in sort.u32.spmd
(TeraSorter.step): input bytes of every completed stage (keys and
payloads as the cell carries them) over the window's seconds; an
overflowed stage counts as failed, not work."""

from shufflebench.readers import completed_gbps


def read(run):
    return completed_gbps(run)
