"""The port's synthetic-MAP data layer (tables, oracles, RPGM generators)
against the JAX package's: the same arguments and seeds, the same bits."""

import numpy as np
import pytest

from fgnn_tpu.data import rpgm as j_rpgm
from fgnn_tpu.data import rpgm_oracle as j_oracle
from fgnn_tpu.data import tables as j_tables
from fgnn_tpu_torch.data import rpgm as t_rpgm
from fgnn_tpu_torch.data import rpgm_oracle as t_oracle
from fgnn_tpu_torch.data import tables as t_tables


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,args", [
    ("chain_knn_table", (30, 8)), ("chain_knn_table", (12, 5)),
    ("chain_knn_table", (12, 4, True)), ("pw_factor_table", (30,)),
    ("high_factor_table", (30, 9)), ("high_factor_table", (12, 5)),
    ("global_factor_table", (30, 8)), ("global_factor_table", (12, 5))])
def test_tables_match(name, args):
    _equal(getattr(t_tables, name)(*args), getattr(j_tables, name)(*args))


def test_chain_knn_table_keeps_the_reference_quirk():
    # the asymmetric window fills k - 1 slots; the last stays 0
    nn, ef = t_tables.chain_knn_table(30, 8)
    assert not nn[:, -1].any() and not ef[:, -1].any()


@pytest.mark.parametrize("caps", [3, "per_window"])
def test_oracles_match(caps):
    rng = np.random.RandomState(5)
    L, h = 11, 5
    lops = rng.uniform(0, 1, (L, 2))
    pws = np.zeros((L - 1, 2, 2))
    pws[:, 1, 1] = rng.uniform(0, 2, L - 1)
    if caps == "per_window":
        caps = rng.randint(1, h, L - h + 1)
    for fn in ("map_chain_budget", "lp_relaxation_chain_budget",
               "brute_force_chain_budget"):
        _equal(getattr(t_oracle, fn)(lops, pws, caps, h),
               getattr(j_oracle, fn)(lops, pws, caps, h))
    # the DP is exact: the brute force finds the same value
    _, v = t_oracle.map_chain_budget(lops, pws, caps, h)
    _, vb = t_oracle.brute_force_chain_budget(lops, pws, caps, h)
    assert abs(v - vb) < 1e-9


@pytest.mark.parametrize("make", [
    lambda m: m.RandomPGM(12, 3, hop_order=5, seed=1),
    lambda m: m.RandomPGMNoHop(12, hop_order=5, seed=2),
    lambda m: m.RandomPGMPw(12, 3, hop_order=5, ret_efeature=False, seed=3),
    lambda m: m.RandomPGMPw(12, 3, hop_order=5, ret_efeature=True, seed=3),
    lambda m: m.RandomPGMPwNoHop(12, hop_order=5, seed=4),
    lambda m: m.RandomPGMHop(12, hop_order=5, ret_efeature_pw=False,
                             seed=5),
    lambda m: m.RandomPGMHop(12, hop_order=4, seed=6),  # forced odd
], ids=["pgm", "nohop", "pw", "pw_efeature", "pw_nohop", "hop", "hop_even"])
def test_rpgm_batches_bit_identical(make):
    tb = list(t_rpgm.batches(make(t_rpgm), 3, 2))
    jb = list(j_rpgm.batches(make(j_rpgm), 3, 2))
    assert len(tb) == len(jb) == 2
    for a, b in zip(tb, jb):
        assert sorted(a) == sorted(b)
        assert {"node_feature", "label", "lp_label"} <= set(a)
        for k in a:
            _equal(a[k], b[k])
