"""``decoder_forward_grad``: the decoder with d sdf / d xyz in forward mode,
(rows, 32) -> (rows, 2) + (rows, 3)."""

from fusion_bench.rooflines import DECODER_HIDDEN_MACS, DECODER_WEIGHT_WORDS, MLP_PASSES, \
    PEAK_TF32

# the tangents' products on the tensor cores: lin1, lin2 and lin3's first 96 inputs
TANGENT_TC_MACS = 3 * (128 * 128 + 128 * 96 + 96 * 128)


def work(rows: int):
    return (MLP_PASSES * 2.0 * (DECODER_HIDDEN_MACS + TANGENT_TC_MACS) * rows,
            rows * (32 + 2 + 3) * 4.0 + DECODER_WEIGHT_WORDS * 4.0, PEAK_TF32)
