"""``decoder_forward``: the prior's decoder, (rows, 32) -> (rows, 2)."""

from fusion_bench.rooflines import DECODER_HIDDEN_MACS, DECODER_WEIGHT_WORDS, MLP_PASSES, \
    PEAK_TF32


def work(rows: int):
    return (MLP_PASSES * 2.0 * DECODER_HIDDEN_MACS * rows,
            rows * (32 + 2) * 4.0 + DECODER_WEIGHT_WORDS * 4.0, PEAK_TF32)
