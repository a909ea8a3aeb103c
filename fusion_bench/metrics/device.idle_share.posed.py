"""``device.idle_share`` in the posed cell, where it moves another metric."""

from fusion_bench import discovery

read = discovery.metric_reader("device.idle_share")
