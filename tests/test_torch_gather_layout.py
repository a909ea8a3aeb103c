"""The gathers' launch arithmetic (``ops/gather.py``), walked on the CPU.

The kernels of ``csrc/gather.cu`` run only on the card; what they do with
their grid is written out here as the kernels' loops: the row gather's
(block, thread, r) mapping, its vector index loads and stores, and the lane
gather's two-slot ring with its barrier parities.  Numpy only.
"""

import numpy as np
import pytest
import torch

from nerf_fusion_tpu_torch.ops import gather, imgproc, launches, photometric

SIZES = [0, 1, 3, 4, 5, 24576, 76800, 307200, 307201, 1081345]


def _row_walk(m: int, r: int, threads: int, blocks: int):
    """The kernel's loop in numpy: (block, thread, row) for every output row
    written, in the order each thread writes them.  Thread t of block b
    takes the groups g = b * threads + t + k * threads * blocks below
    ceil(m / r); a group is rows g * r .. g * r + r - 1, the last one cut
    at m.  The row's index is read by the thread that writes the row."""
    stride = threads * blocks
    groups = -(-m // r)
    g = np.arange(groups, dtype=np.int64)
    rows = (g[:, None] * r + np.arange(r, dtype=np.int64)[None, :]).reshape(-1)
    g = np.repeat(g, r)
    keep = rows < m
    rows, g = rows[keep], g[keep]
    t = g % stride
    return t // threads, t % threads, rows


def _emulate_rows(rows, idx, offset, r, threads, blocks, vec):
    """The row kernel's loop, thread by thread: each full group loads its r
    indices (as one vector where ``vec``: the address must then be aligned
    to r indices) and stores its r rows as vectors of min(r * C, 4) floats
    at aligned output addresses; the last group moves row by row.  Returns
    the output and the times each index was read and each row written."""
    n, m = rows.shape[0], idx.shape[0]
    c = rows.shape[1]
    out = np.full((m, c), np.nan, np.float32)
    reads, writes = np.zeros(m, np.int64), np.zeros(m, np.int64)
    groups = -(-m // r)
    width = min(r * c, 4)
    for t in range(threads * blocks):
        for g in range(t, groups, threads * blocks):
            i0 = g * r
            if i0 + r <= m:
                if vec:
                    assert (4 * (offset + i0)) % (4 * r) == 0
                j = idx[i0:i0 + r]
                reads[i0:i0 + r] += 1
                assert (i0 * c * 4) % (4 * width) == 0
                out[i0:i0 + r] = rows[np.clip(j, 0, n - 1)]
                writes[i0:i0 + r] += 1
            else:
                for i in range(i0, m):
                    reads[i] += 1
                    out[i] = rows[min(max(idx[i], 0), n - 1)]
                    writes[i] += 1
    return out, reads, writes


@pytest.mark.parametrize("m", SIZES)
def test_row_walk_writes_every_row_once(m):
    """Every output row is written, and its index read, exactly once, by
    one thread in consecutive groups of r rows; the plan's launch fits the
    kernel's limits and reaches every SM once there are rows for it."""
    r, threads, blocks = gather.row_plan(m)
    assert r in (1, 2) and r <= gather.ROW_MAX_R
    assert gather.ROW_MIN_THREADS <= threads <= gather.ROW_THREADS and threads % 32 == 0
    resident = min(gather.SM_BLOCKS, gather.SM_THREADS // threads)
    assert 1 <= blocks <= gather.SMS * resident
    groups = -(-m // r)
    if groups >= gather.SMS * gather.ROW_MIN_THREADS:
        assert blocks >= gather.SMS
    block, thread, rows = _row_walk(m, r, threads, blocks)
    assert np.array_equal(np.bincount(rows, minlength=m), np.ones(m, np.int64))
    assert block.max(initial=0) < blocks and thread.max(initial=0) < threads
    # a group's r rows belong to one thread, which takes every
    # (threads * blocks)-th group
    assert np.array_equal(block * threads + thread, (rows // r) % (threads * blocks))


def test_row_plan_reaches_every_sm_in_one_wave():
    """The selection's 24576 rows at 132 SMs: a grid of at least
    132 blocks (one row a thread in 256-thread blocks gives 96 and leaves 36
    SMs idle).  More rows a thread only past one wave of resident threads:
    the dense warp's 76800 rows one a thread, the probe's 307200 two; past
    two waves still two, with a second round of the grid-stride loop."""
    assert gather.row_plan(24576) == (1, 128, 192)
    resident = gather.SMS * gather.SM_THREADS
    for m, r in ((76800, 1), (307200, 2), (2 * resident, 2), (4 * resident + 1, 2)):
        plan = gather.row_plan(m)
        assert plan[0] == r
        assert -(-m // plan[0]) <= resident or plan[0] == gather.ROW_MAX_R
        if m > 2 * resident:            # the grid-stride loop's second round
            assert plan[1] * plan[2] < -(-m // plan[0])


@pytest.mark.parametrize("c", gather.ROW_WIDTHS)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("m", [1, 3, 5, 130, 1027])
def test_row_kernel_emulation_matches_plain(m, c, offset):
    """The kernel's loop at an index vector ``offset`` indices past a
    16-byte boundary (``idx[offset:]``), at several plans: the plain
    gather's result, each row written and each index read once, vector
    loads only at aligned addresses."""
    rng = np.random.default_rng(m * 16 + c * 4 + offset)
    n = 97
    rows = rng.normal(size=(n, c)).astype(np.float32)
    rows[rng.integers(0, n, 3)] = np.nan
    idx = rng.integers(-5, n + 5, m).astype(np.int32)
    ref = gather.row_gather_plain(torch.from_numpy(rows), torch.from_numpy(idx)).numpy()
    plans = {gather.row_plan(m, sms=4)}
    plans |= {(r, 32, b) for r in (1, 2) for b in (1, 3)}
    for r, threads, blocks in plans:
        vec = gather.row_vector_index(4096 + 4 * offset, r)
        assert vec == (r > 1 and offset % r == 0)
        out, reads, writes = _emulate_rows(rows, idx, offset, r, threads, blocks, vec)
        assert np.array_equal(reads, np.ones(m)) and np.array_equal(writes, np.ones(m))
        assert np.array_equal(np.isnan(out), np.isnan(ref))
        assert np.array_equal(out[~np.isnan(out)], ref[~np.isnan(ref)])


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("h", [1, 131, 480])
def test_lane_ring_visits_each_row_once_and_flips_parity(h, k):
    """Every row is read once by one block; a block alternates slots from
    slot 0, the k-th use of a slot waits for parity k % 2, and the copy a
    step issues fills the slot the next step reads, never the one being
    read.  The ring emulated: a slot's barrier completes a phase when its
    copy lands; a wait on parity p passes once the slot's phase p is done."""
    blocks = gather.lane_plan(h, sms=132, k=k)
    assert blocks == min(h, 132 * k)
    seen = np.zeros(h, np.int64)
    for block in range(blocks):
        steps = gather.lane_schedule(h, blocks, block)
        assert steps and steps[0][0] == block
        ring, done, uses = [None, None], [0, 0], [0, 0]
        ring[0], done[0] = steps[0][0], 1          # the prologue's copy
        for i, (row, slot, parity, nxt) in enumerate(steps):
            seen[row] += 1
            assert slot == i % 2
            if nxt >= 0:
                assert nxt == steps[i + 1][0] and steps[i + 1][1] == 1 - slot
                ring[1 - slot] = nxt
                done[1 - slot] += 1
            else:
                assert i == len(steps) - 1
            assert parity == uses[slot] % 2 and done[slot] == uses[slot] + 1
            assert ring[slot] == row
            uses[slot] += 1
    assert np.array_equal(seen, np.ones(h, np.int64))


def test_lane_bulk_needs_16_byte_rows_and_operands():
    assert gather.lane_bulk(3200, 0, 256, 512)
    assert not gather.lane_bulk(3201, 0, 256, 512)          # B % 4 != 0
    assert not gather.lane_bulk(3200, 0, 4, 512)            # idx[1:]-like offset
    assert gather.lane_bulk(gather.LANE_MAX, 16, 32, 48)


def test_trace_names_map_to_the_counters():
    assert launches.counter_of("void (anonymous namespace)::row_gather_kernel<2, 2, true>"
                               "(float2 const*, int, int const*, int, float*)") == \
        "row_gather_c2"
    assert launches.counter_of("void (anonymous namespace)::row_gather_kernel<1, 1, false>"
                               "(float const*, int, int const*, int, float*)") == \
        "row_gather_c1"
    assert launches.counter_of("(anonymous namespace)::lane_gather_kernel(float const*, "
                               "int const*, int, int, int, float*)") == "lane_gather"


def test_plain_references_call_no_gather_kernel(monkeypatch):
    """``photometric_hg_plain`` (through ``rgb_odometry`` and
    ``rgb_odometry_sparse``) and ``select_gather_plain`` gather with
    ``row_gather_plain``: with the kernel wrapper made to fail they still
    run (the card test holds the launch counters)."""
    def refuse(*a, **k):
        raise AssertionError("a plain reference called the row_gather wrapper")

    monkeypatch.setattr(gather, "row_gather", refuse)
    g = torch.Generator().manual_seed(0)
    h, w = 24, 32
    inten, depth = torch.rand(h, w, generator=g), 1.0 + torch.rand(h, w, generator=g)
    grad = torch.randn(2, h, w, generator=g)
    rows = imgproc.intensity_depth_rows(inten, depth)
    K = torch.eye(3)
    kt = torch.tensor([0.3, -0.2, 0.01])
    kw = dict(min_grad_scale=0.0, max_depth_delta=0.5, stride=2, robust_kernel="huber",
              robust_k=0.05, rgb_weight=1.0)
    dense = photometric.Dense(inten, depth, grad)
    photometric.photometric_hg_plain(rows, dense, K, kt, 20.0, 20.0, 15.5, 11.5, **kw)
    vals, order = torch.sort(torch.rand(h * w, generator=g), descending=True, stable=True)
    pix = gather.select_gather_plain(vals, order, 100, w, (inten, depth, grad[0], grad[1]))
    sparse = photometric.Sparse(w, h, pix)
    photometric.photometric_hg_plain(rows, sparse, K, kt, 20.0, 20.0, 15.5, 11.5, **kw)
