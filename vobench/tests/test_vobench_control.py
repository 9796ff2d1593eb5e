"""The control at a size a test run holds: the reference computed with TF32
matrix products, in the program's place, moves away from the reference,
while the port's own CPU path reads 0 against it. Its readings at the
cells' own sizes come from the card's machine (PERF.md)."""

import pytest
import torch

from vobench import check, control, run
from vobench.reference.tf32 import round_tf32, tf32_products
from vobench.tests.helpers import small_cell


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 3.0e38, float("nan")])
    y = round_tf32(x)
    assert y[:5].tolist() == [1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), round_tf32(x)[4]]
    assert torch.isnan(y[5])
    bits = y[:4].view(torch.int32) & 0x1FFF
    assert bits.eq(0).all()


def test_products_are_rounded_inside_the_block_only():
    a = torch.randn(8, 8) + 1e-3
    plain = a @ a
    with tf32_products():
        rounded = (a @ a, torch.einsum("ij,jk->ik", a, a), torch.matmul(a, a))
    assert all(torch.equal(r, rounded[0]) for r in rounded)
    assert not torch.equal(rounded[0], plain)
    assert torch.equal(a @ a, plain)


@pytest.mark.parametrize("name", ["kitti00.stream", "kitti00.replay", "d435i.stream"])
def test_control_moves_off_the_reference(name):
    cell = small_cell(name, frames=12, chunk=4)
    got = control.readings(cell, 1)
    assert got["quat_gap"] > 0 and got["trans_gap"] > 0
    own = run.run_cell(cell, 1, 0.2, False, device="cpu", log=lambda m: None)
    assert all(c["value"] == 0.0 for k, c in own["check"].items() if k != "traj_err")
    assert set(got) <= set(check.NUMBERS)
    assert set(cell.config["limits"]) - {"warm_gap"} <= set(got)
