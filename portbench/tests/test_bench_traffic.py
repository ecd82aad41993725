"""The frozen traffic generators give the port's data layer's samples bit
for bit, for one seed; the pools do not depend on the workers."""

import numpy as np

from fgnn_tpu_torch.data import (ContinuousCodesSP, MixedLengthHopData,
                                 RandomPGMHop, batches)
from portbench.traffic import ldpc_words, rpgm_hop

SEED = 2147483001


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_ldpc_words_are_the_ports():
    got = ldpc_words.words(SEED, 40, [0, 1, 2, 3, 4], [0, 1, 2, 3, 4, 5],
                           0.05)
    want = next(ContinuousCodesSP(length=40, seed=SEED).batches(40))
    _equal(got, want)


def test_hop_chains_are_the_ports():
    got = rpgm_hop.samples(SEED, 6, [30], 9)
    want = next(batches(RandomPGMHop(30, hop_order=9, ret_efeature_pw=False,
                                     seed=SEED), 6, 1))
    _equal(got, want)


def test_mixed_composites_are_the_ports():
    got = rpgm_hop.samples(SEED, 3, [24, 30, 36], 9)
    ds = MixedLengthHopData([24, 30, 36], hop_order=9, seed=SEED)
    want = next(batches(ds, 3, 1))
    _equal(got, want)


def test_pools_do_not_depend_on_workers():
    mix = {"pool_batches": 2, "chunk": 4, "snr_db": [0, 4],
           "sigma_b": [0, 5], "burst_prob": 0.05}
    one = ldpc_words.make_pool(mix, 7, 8, 1)
    two = ldpc_words.make_pool(mix, 7, 8, 3)
    assert len(one) == 2
    for a, b in zip(one, two):
        _equal(a, b)
    assert not np.array_equal(one[0]["node_feature"], one[1]["node_feature"])
    hop = {"pool_batches": 2, "chunk": 2, "lengths": [12], "hop_order": 5}
    a, b = rpgm_hop.make_pool(hop, 7, 4, 1), rpgm_hop.make_pool(hop, 7, 4, 2)
    for x, y in zip(a, b):
        _equal(x, y)


def test_large_seeds():
    mix = {"pool_batches": 1, "chunk": 2, "snr_db": [0], "sigma_b": [5],
           "burst_prob": 0.05}
    for seed in (2 ** 31 + 12345, 2 ** 32 + 7, 2 ** 40):
        pool = ldpc_words.make_pool(mix, seed, 2, 1)
        assert np.isfinite(pool[0]["node_feature"]).all()
