"""PyTorch port: ``hit.read_rows``, the winner-row read whose gradient sums
each table row's lanes in an order fixed by the data (``hit.row_sum``).

Its forward is ``index_select`` bit for bit.  Its gradient is
``index_add_``'s up to the order of the sums: in f64 within 1e-13 of the
row's sum of magnitudes (f64 rounding), in f32 within 2e-5 of it against
the exact (f64) sum -- a bound on any order of f32 additions over
chunks of ``ROW_CHUNK`` lanes, the order ``index_add_`` uses included.
The ids are seeded with one hot row holding 90% of the lanes, as the
ground sphere holds most lanes of a frame.
"""

import numpy as np
import pytest
import torch

from raytracinginoneweekendincuda_torch.ops import hit
from torch_threads import one_torch_thread  # noqa: F401

ROWS, COLS = 489, 27          # scene 0's replay table: S + Q rows, 27 wide


def seeded(n: int, rows: int, dtype):
    rs = np.random.default_rng(n)
    idx = rs.integers(0, rows, n)
    idx[rs.random(n) < 0.9] = rows // 3               # the hot row
    grad = rs.standard_normal((n, COLS))
    return torch.as_tensor(idx), torch.as_tensor(grad, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
# one level and two (the frame's 230,400 lanes), at and around one chunk,
# and three (more lanes than ROW_CHUNK ** 2)
@pytest.mark.parametrize("n", [1, hit.ROW_CHUNK - 1, hit.ROW_CHUNK,
                               hit.ROW_CHUNK + 1, 65_537, 230_400,
                               hit.ROW_CHUNK ** 2 + 1])
def test_gradient_equals_index_add(n, dtype):
    idx, w = seeded(n, ROWS, dtype)
    table = torch.zeros((ROWS, COLS), dtype=dtype, requires_grad=True)
    out = hit.read_rows(table, idx)
    (out * w).sum().backward()
    exact = torch.zeros((ROWS, COLS), dtype=torch.float64).index_add_(
        0, idx, w.double())
    scale = torch.zeros((ROWS, COLS), dtype=torch.float64).index_add_(
        0, idx, w.double().abs())
    rtol = 1e-13 if dtype == torch.float64 else 2e-5
    err = (table.grad.double() - exact).abs()
    assert bool((err <= rtol * scale).all()), float((err / scale).max())
    if dtype == torch.float64:
        ref = torch.zeros_like(table).index_add_(0, idx, w)
        assert bool(((table.grad - ref).abs() <= 1e-13 * scale).all())


def test_forward_is_index_select():
    idx, _ = seeded(4096, ROWS, torch.float32)
    table = torch.randn((ROWS, COLS), requires_grad=True)
    got = hit.read_rows(table, idx)
    assert torch.equal(got, table.index_select(0, idx))
    assert torch.equal(hit.read_rows(table.detach(), idx),
                       table.detach().index_select(0, idx))


def test_every_row_and_one_row():
    """Ids on every row (one lane each, in reverse), and all on one row."""
    for idx in (torch.arange(ROWS - 1, -1, -1),
                torch.full((70_000,), ROWS - 1)):
        w = torch.randn((idx.shape[0], COLS), dtype=torch.float64)
        got = hit.row_sum(idx, w, ROWS)
        want = torch.zeros((ROWS, COLS), dtype=torch.float64).index_add_(
            0, idx, w)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
