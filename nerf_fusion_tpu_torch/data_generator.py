"""LIF dataset generation entry point.

    python -m nerf_fusion_tpu_torch.data_generator configs/data-simple.yaml \
        [--exec "provider_kwargs['n_shapes']=4;output='DIR'"]

Reads the same YAML as the JAX entry point (``data_generator.py``) and
writes the same dataset under ``output``: ``payload/%08d.npz`` (one LIF
each: ``data`` (N, 4) xyz + sdf and ``surface`` (M, 6) xyz + normal, in
voxel-local units, ``min`` / ``max``), ``mesh/%06d.obj``, ``source.json``
and ``config.json``.  Host work (numpy, scipy and the native sampler,
built with ``g++`` at first use); no GPU.
"""

from __future__ import annotations

import logging

from .data.generator import run_generator
from .utils import config as exp_util


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    exp_util.init_seed(4)
    parser = exp_util.ArgumentParserX(description="LIF data generator")
    args = parser.parse_args(argv)
    return run_generator(args)


if __name__ == "__main__":
    main()
