"""The benchmark's arithmetic against hand counts at small shapes."""

import statistics

import pytest
import torch

from portbench import yardstick
from portbench.reference import common as C


def test_typed_forward_cost():
    # B=2, N=3 source rows, Nd=4, K=2, T=3, C=5, f32: h 2*3*3*5=90, out
    # 2*4*5=40 (4 bytes each), table 4*2=8 and etype 2*4*2*3=48 ints/floats
    nbytes, ops = yardstick.typed_fwd_cost(2, 3, 4, 2, 3, 5)
    assert nbytes == 4 * (90 + 40) + 4 * (8 + 48)
    assert ops == 2 * 4 * 2 * 5 * (2 * 3 + 1)
    # the argmax adds a byte per output element; bf16 halves h and out
    assert yardstick.typed_fwd_cost(2, 3, 4, 2, 3, 5, argmax=True)[0] \
        == nbytes + 40
    assert yardstick.typed_fwd_cost(2, 3, 4, 2, 3, 5, esz=2)[0] \
        == 2 * 130 + 4 * 56
    # DIFF/NEIGHBOR: h holds 2 Nd rows; 3 T + 1 operations per edge/channel
    nbytes, ops = yardstick.typed_fwd_cost(1, 8, 4, 2, 1, 2, ext=True)
    assert nbytes == 4 * (8 * 2 + 4 * 2) + 4 * (8 + 8)
    assert ops == 4 * 2 * 2 * 4


def test_typed_backward_cost():
    # g 2*4*5=40, argmax 40 bytes, h 90 read and dh 90 written, etype 48
    # read and d_etype 48 written, tables 8 + (3 + 1) + 8 ints
    nbytes, ops = yardstick.typed_bwd_cost(2, 3, 4, 2, 3, 5, "max")
    assert nbytes == 4 * 40 + 40 + 2 * 4 * 90 + 2 * 4 * 48 + 4 * 20
    assert ops == 2 * 4 * 2 * 5 * (4 * 3 + 1)
    # softmax keeps out (4 bytes); the extension lists each edge twice
    nb, ops = yardstick.typed_bwd_cost(1, 8, 4, 2, 1, 2, "softmax", ext=True)
    assert nb == 4 * 8 + 4 * 8 + 2 * 4 * 16 + 2 * 4 * 8 + 4 * (8 + 9 + 16)
    assert ops == 4 * 2 * 2 * (7 + 1 + 3)


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(3.35e12, 134e12) == pytest.approx(2.0)


def test_counted_operations():
    ctr = C.Counter()
    x = torch.zeros(2, 3, 4)
    P = {"d.weight": torch.zeros(5, 4), "d.bias": torch.zeros(5)}
    C.dense(x, P, "d", ctr)
    assert ctr.flops == 2 * 6 * 4 * 5
    ctr = C.Counter()
    idx = torch.zeros(7, 2, dtype=torch.long)
    C.typed_conv(x, idx, torch.zeros(2, 7, 2, 3), torch.zeros(4, 5 * 3),
                 torch.zeros(5), 5, "max", ctr=ctr)
    # x @ W over the 2 * 3 source rows, then 2 K T C per destination row
    assert ctr.flops == 2 * 6 * 4 * 15 + 2 * 14 * 2 * 3 * 5
    assert ctr.convs == [dict(n_src=3, nd=7, k=2, t=3, c=5, ext=False,
                              aggregator="max")]
    ctr = C.Counter()
    C.diff_conv(torch.zeros(6, 4), torch.zeros(6, 3, dtype=torch.long),
                torch.zeros(6, 3, 2), torch.zeros(8, 5 * 2), torch.zeros(5),
                5, "softmax", ctr=ctr)
    # both halves of the filters per node, then 2 K T C per row
    assert ctr.flops == 2 * 6 * 4 * 2 * 5 * 2 + 2 * 6 * 3 * 2 * 5


def test_quartile_spread():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q = statistics.quantiles(vals, n=4)
    assert yardstick.quartile_spread(vals) == pytest.approx(
        (q[2] - q[0]) / 12.5)
