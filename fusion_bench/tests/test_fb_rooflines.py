"""The kernels' work functions reproduce the bound column of PERF.md's
kernel table at its shapes."""

import pytest

from fusion_bench import discovery


@pytest.mark.parametrize("kernel,sizes,ms,digit", [
    ("decoder_forward", {"rows": 262144}, 0.1562, 1e-4),
    ("decoder_forward_grad", {"rows": 8192}, 0.0171, 1e-4),
    ("encoder_forward", {"rows": 327680}, 0.1035, 1e-4),
    ("decoder_vjp", {"rows": 327680}, 0.3925, 1e-4),
    ("photometric_hg", {"pixels": 76800, "touched": 76800}, 0.00055, 1e-5),
    ("gn_step", {}, 1.2e-7, 1e-8),
])
def test_table_bounds(kernel, sizes, ms, digit):
    """Within half a unit of the table's last digit."""
    got = 1e3 * discovery.bound_s(kernel, **sizes)
    assert abs(got - ms) <= digit / 2


def test_every_roofline_kernel_has_its_file():
    from fusion_bench.kernels import NAMES

    for _, kernel in NAMES + (("", "stencil_frontend"),):
        ops, nbytes, peak = discovery.roofline(kernel)(**(
            {} if kernel == "gn_step" else
            {"pixels": 100} if kernel in ("photometric_hg", "stencil_frontend") else
            {"selected": 100} if kernel == "select_gather" else {"rows": 100}))
        assert ops > 0 and nbytes > 0 and peak > 0


def test_model_flops_count_each_row_once():
    from fusion_bench.rooflines import model_flops

    assert model_flops("decoder_forward", 1) == 2 * 49408
    assert model_flops("encoder_forward", 1) == 2 * 26048
    assert model_flops("decoder_forward_grad", 1) == 2 * (49408 + 3 * 41088)


def _ctx(extractions, launches):
    cfg = {"fusion": {"resolution": 4}}
    return {"config": cfg, "trace": {
        "frames": [40, 41], "launches": launches, "valid_points": [21000, 20500],
        "gn_rows": [8192, 8000], "extractions": extractions}}


def test_mlp_rows_are_what_the_inputs_need():
    """An extraction's kept voxels x (2r)^3 samples once for all its decoder
    calls, 8 rows a valid point for the encoder, the valid rows of the SDF
    term a call: not the buffers' capacities or the decoder's chunks."""
    from fusion_bench.kernels import mlp_rows

    ctx = _ctx([(40, 883, 2)], [{"decoder_forward": 2, "encoder_forward": 1},
                                {"decoder_forward_grad": 6}])
    rows, unknown = mlp_rows(ctx, 0)
    assert not unknown
    assert rows == {"decoder_forward": [(883 * 512, 2, 1)], "encoder_forward": [(168000, 1, 1)]}
    rows, unknown = mlp_rows(ctx, 1)
    assert rows == {"decoder_forward_grad": [(8000, 6, 6)]} and not unknown


def test_unsized_calls_leave_the_metric_out():
    """A decoder call outside any extraction the harness saw has no size."""
    from fusion_bench.kernels import mlp_flops, mlp_rows

    ctx = _ctx([(40, 883, 1)], [{"decoder_forward": 2}, {}])
    assert mlp_rows(ctx, 0)[1] == {"decoder_forward"}
    assert mlp_flops(ctx, [0, 1]) is None
