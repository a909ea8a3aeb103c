"""``select_gather``: the sparse term's selected pixels, ``selected`` of a
sorted score plane: the sorted score and index read (12 bytes), four
planes gathered (16 bytes) and seven vectors written (25 bytes) a pixel."""

from fusion_bench.rooflines import PEAK_F32


def work(selected: int):
    return 2.0 * selected, selected * (12 + 16 + 25.0), PEAK_F32
