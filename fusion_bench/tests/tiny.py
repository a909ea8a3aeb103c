"""A cell at a size a CPU test run holds: 160x120 frames, an 8-frame orbit
(a 14-frame cycle), integration and meshing every 4 frames, the outlier
and normal gates lowered so that the coarse pixels keep points, and no
encoder cap and a lower pruning count, so that every integration moves
latents."""

TINY = {"config": {"fusion": {"integrate_interval": 4, "meshing_interval": 4,
                              "mapping": {"encoder_count_th": 1e9, "prune_min_vox_obs": 2},
                              "tracking": {"preprocess": {"outlier_min_nb": 4,
                                                          "normal_min_nb": 3}}}},
        "traffic": {"camera": {"width": 160, "height": 120}, "trajectory": {"n_frames": 8},
                    "trace_cycles": 1}}
SEED = 2 ** 31 + 977


def run(workload: str = "room.orbit", seconds: float = 3.0, **kw):
    from fusion_bench import harness

    return harness.run_cell(workload, SEED, seconds, kw.pop("trace", False), device="cpu",
                            overrides=TINY, log=lambda msg: None, **kw)
