"""The RMSNorm kernels' launch plan (`kernels.fused_norm.plan`), on the CPU.

The plan is pure Python: it fixes the layout that csrc/fused_norm.cu's
forward and backward kernels run (threads a row, rows a block, 16-byte
or scalar accesses, chunks a thread, grid). These tests walk the rows as
the kernels do and check that the plan covers every row and column once
and fits the kernels' compiled limits.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import fused_norm as tfn

_NS = (0, 1, 8, 6370, 16384)
_DS = (1, 64, 1002, 2048, 4096, 4100, 12032)


def _rows_walked(p, n, backward):
    """Every row the kernel's blocks visit, in the kernel's own order: the
    forward's block b holds the group b; the backward's block b walks the
    groups b, b + blocks, ... while group * rows_per_block < n."""
    rpb = p.rows_per_block
    groups = -(-n // rpb)
    team = np.arange(rpb)
    seen = []
    for b in range(p.blocks):
        gs = np.arange(b, groups, p.blocks) if backward else np.array([b])
        rows = (gs[:, None] * rpb + team[None, :]).reshape(-1)
        seen.append(rows[rows < n])
    return np.concatenate(seen) if seen else np.zeros(0, np.int64)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", _DS)
@pytest.mark.parametrize("n", _NS)
def test_norm_plan_covers_every_row_and_column_once(n, d, dtype, backward):
    p = tfn.plan(n, d, dtype, backward=backward)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    # the scalar instance exactly when a row is not whole 16-byte chunks
    assert p.vector == (d * itemsize % 16 == 0)
    assert p.vec == (16 // itemsize if p.vector else 1)
    tpr, rpb = p.threads_per_row, p.rows_per_block
    assert tpr & (tpr - 1) == 0 and tpr >= (32 if backward else 1)
    threads = tpr * rpb
    assert threads <= 1024 and threads <= tfn._MAX_TEAM
    assert threads % 32 == 0                # whole warps: full-mask shuffles
    # thread t holds chunks t, t + tpr, ...: the team covers the row
    assert p.chunks in tfn._CHUNKS[p.vector]
    assert p.vec * tpr * p.chunks >= d
    assert p.chunks == min(c for c in tfn._CHUNKS[p.vector]
                           if p.vec * tpr * c >= d)
    chunk = np.arange(p.chunks)[:, None] * tpr + np.arange(tpr)[None, :]
    cols = (chunk[..., None] * p.vec + np.arange(p.vec)).reshape(-1)
    cols = cols[cols < d]
    assert len(cols) == d and np.array_equal(np.unique(cols), np.arange(d))
    if n == 0:
        assert p.blocks == 0                 # launches nothing
        return
    if backward:                             # at most 1024 threads an SM
        assert 1 <= p.blocks * threads <= 132 * max(1024, threads)
    else:
        assert p.blocks == -(-n // rpb)
    counts = np.bincount(_rows_walked(p, n, backward), minlength=n)
    assert counts.shape == (n,) and (counts == 1).all()


@pytest.mark.parametrize("backward", [False, True])
def test_norm_plan_takes_the_scalar_instance_for_unaligned_views(backward):
    p = tfn.plan(8, 4096, torch.bfloat16, aligned=False, backward=backward)
    assert not p.vector and p.vec == 1
    assert p.threads_per_row * p.chunks >= 4096
    assert tfn.plan(8, 4096, torch.bfloat16, backward=backward).vector


def test_norm_plan_widens_the_forward_team_when_rows_are_few():
    # decode: one or two 16-byte loads a thread; training: four, and
    # several rows a block
    dec = tfn.plan(8, 4096, torch.bfloat16)
    assert (dec.threads_per_row, dec.chunks, dec.rows_per_block) == (256, 2, 1)
    train = tfn.plan(16384, 2048, torch.bfloat16)
    assert (train.threads_per_row, train.chunks) == (64, 4)
    assert train.rows_per_block == 4
    pre = tfn.plan(6370, 4096, torch.bfloat16)
    assert (pre.threads_per_row, pre.chunks, pre.rows_per_block) == (128, 4, 2)


def test_norm_plan_puts_one_backward_block_on_each_sm():
    # two accesses a thread, a 512-thread block on each SM: 132 partials
    bwd = tfn.plan(16384, 2048, torch.bfloat16, backward=True)
    assert (bwd.threads_per_row, bwd.chunks, bwd.rows_per_block,
            bwd.blocks) == (128, 2, 4, 132)
    assert tfn.plan(16384, 2048, torch.bfloat16, backward=True,
                    sms=114).blocks == 114
    assert tfn.plan(3, 2048, torch.bfloat16, backward=True).blocks == 1
