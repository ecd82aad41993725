"""The port's data loading (fgnn_tpu_torch.data.loader) against the JAX
package's (fgnn_tpu.data.loader), on the CPU.

* ``Prefetcher``: order, ``close()`` mid-stream, a producer's error raised
  in the consumer, a fast producer against a slow consumer;
* ``device_prefetch``: on the CPU the put is the identity, and the staged
  batches are those staged inline;
* ``PoolBatcher``: batches bit-equal to the JAX package's pool at 1 and 3
  workers, for the hop dataset and ``ContinuousCodesSP``, forked and
  spawned.
"""

import functools
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from fgnn_tpu.data import ldpc_datasets as j_ds
from fgnn_tpu.data import rpgm as j_rpgm
from fgnn_tpu.data.loader import PoolBatcher as JPoolBatcher
from fgnn_tpu_torch.data import ldpc_datasets as t_ds
from fgnn_tpu_torch.data import loader
from fgnn_tpu_torch.data import rpgm as t_rpgm

DATASETS = {
    "hop": (functools.partial(t_rpgm.RandomPGMHop, 12, hop_order=5,
                              ret_efeature_pw=False, seed=3),
            functools.partial(j_rpgm.RandomPGMHop, 12, hop_order=5,
                              ret_efeature_pw=False, seed=3)),
    "codes": (functools.partial(t_ds.ContinuousCodesSP, length=64, seed=3),
              functools.partial(j_ds.ContinuousCodesSP, length=64, seed=3)),
}


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prefetcher_keeps_order_and_ends():
    with loader.prefetch(iter(range(50)), depth=3) as pf:
        assert list(pf) == list(range(50))
        assert list(pf) == []


def test_prefetcher_close_stops_the_worker():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    pf = loader.Prefetcher(gen(), depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._t.is_alive()
    assert len(produced) < 20
    pf.close()  # idempotent


def test_prefetcher_reraises_a_producer_error_after_its_items():
    def gen():
        yield 1
        yield 2
        raise ValueError("synthesis failed")

    pf = loader.Prefetcher(gen(), depth=4)
    assert next(pf) == 1 and next(pf) == 2
    with pytest.raises(ValueError, match="synthesis failed"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_fast_producer_slow_consumer_terminates():
    got = []

    def consume():
        p = loader.Prefetcher(iter(range(10)), depth=2)
        time.sleep(0.3)  # the producer ends against a full queue
        got.extend(p)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive(), "Prefetcher consumer blocked"
    assert got == list(range(10))


def test_device_prefetch_on_the_cpu_is_the_identity_put():
    batches = [{"x": np.full((2, 3), i, np.float32),
                "y": np.arange(4, dtype=np.int32) + i} for i in range(5)]
    with loader.device_prefetch(iter(batches), "cpu") as staged:
        got = list(staged)
    assert len(got) == 5
    for g, b in zip(got, batches):
        for k in b:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), b[k])
    seen = []
    with loader.device_prefetch(iter(batches), "cpu",
                                put=lambda b: seen.append(b) or b) as staged:
        assert [id(b) for b in staged] == [id(b) for b in batches]
    assert seen == batches


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_pool_batches_match_jax(name, workers):
    make_t, make_j = DATASETS[name]
    with loader.PoolBatcher(make_t, 4, n_workers=workers, seed=7) as tp:
        assert tp.start_method == "fork"
        got = list(tp.batches(3))
    with JPoolBatcher(make_j, 4, n_workers=workers, seed=7) as jp:
        want = list(jp.batches(3))
    _assert_batches_equal(got, want)
    # the stream does not depend on the number of workers
    with loader.PoolBatcher(make_t, 4, n_workers=2, seed=7) as tp:
        _assert_batches_equal(list(tp.batches(3)), want)


def test_pool_spawns_in_a_process_that_holds_cuda(monkeypatch):
    """Where CUDA is initialised the pool spawns clean workers from a
    picklable factory: the same stream."""
    make_t, make_j = DATASETS["hop"]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with loader.PoolBatcher(make_t, 4, n_workers=2, seed=5) as tp:
        assert tp.start_method == "spawn"
        got = list(tp.batches(2))
    with JPoolBatcher(make_j, 4, n_workers=2, seed=5) as jp:
        want = list(jp.batches(2))
    _assert_batches_equal(got, want)


def test_pool_seed_changes_the_stream():
    make_t, _ = DATASETS["codes"]
    with loader.PoolBatcher(make_t, 4, n_workers=2, seed=7) as a, \
            loader.PoolBatcher(make_t, 4, n_workers=2, seed=8) as b:
        xa = next(a.batches(1))["node_feature"]
        xb = next(b.batches(1))["node_feature"]
    assert not np.array_equal(xa, xb)


def test_prefetch_of_a_pool_keeps_its_order():
    """The trainers iterate a pool's batches from the prefetch thread."""
    make_t, _ = DATASETS["codes"]
    with loader.PoolBatcher(make_t, 4, n_workers=2, seed=1) as p:
        with loader.device_prefetch(p.batches(3), "cpu") as staged:
            got = [{k: v.numpy() for k, v in b.items()} for b in staged]
    with loader.PoolBatcher(make_t, 4, n_workers=1, seed=1) as p:
        want = list(itertools.islice(p.batches(5), 3))
    _assert_batches_equal(got, want)
