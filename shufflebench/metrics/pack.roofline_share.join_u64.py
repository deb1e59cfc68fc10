"""pack.roofline_share.join_u64 (%, device trace), in join.pkfk.u64.256m
(HashJoin.step at 8-byte rows): the 8-byte pack kernel's share of its
byte bound, ``pack_roofline.py``: the bytes a stage's two packs need
over 3.35 TB/s, against the device time of ``srt_radix_pack64``'s
kernels a stage in the stretch traced without frame annotations. None
where the trace holds no such kernel."""

from shufflebench.pack_roofline import roofline_share


def read(run):
    return roofline_share(run)
