"""PyTorch port, the LM trainer's data pipeline and fault tolerance:
``repro_torch.data.lm_data`` and ``repro_torch.distributed.fault`` against
``repro.data.lm_data`` and ``repro.distributed.fault``.

``batch_at_step`` is numpy in both packages, so its batches are held bitwise
for every family (``src_embeds`` for encdec, ``patch_embeds`` for vlm
included). The ``PrefetchingLoader`` yields those batches from its
``start_step``. Then the watchdog, retry, elastic and data cases of
``tests/test_runtime.py``, run on the port.
"""

import time

import numpy as np
import pytest

from repro.configs import ARCH_IDS, get_config, reduced_config
from repro.data import lm_data as J
from repro.distributed import fault as JF
from repro_torch import configs as TC
from repro_torch.data import PrefetchingLoader, batch_at_step
from repro_torch.distributed.fault import (
    StepWatchdog,
    TransientError,
    elastic_device_counts,
    run_with_retries,
)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_at_step_bitwise(arch):
    jcfg = reduced_config(get_config(arch))
    tcfg = TC.reduced_config(TC.get_config(arch))
    for seed, step, host, n_hosts in ((0, 0, 0, 1), (3, 7, 1, 2)):
        kw = dict(seed=seed, step=step, host=host, n_hosts=n_hosts, batch=4, seq=16)
        want, got = J.batch_at_step(jcfg, **kw), batch_at_step(tcfg, **kw)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = set(got)
    assert ("src_embeds" in keys) == (tcfg.family == "encdec")
    assert ("patch_embeds" in keys) == (tcfg.family == "vlm")


def test_full_size_batch_bitwise():
    """At yi-6b's own vocabulary and a 1,024-token sequence."""
    kw = dict(seed=0, step=2, host=0, n_hosts=1, batch=2, seq=1024)
    want = J.batch_at_step(get_config("yi-6b"), **kw)
    got = batch_at_step(TC.get_config("yi-6b"), **kw)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("start_step", [0, 5])
def test_prefetching_loader_matches_reference(start_step):
    cfg = TC.reduced_config(TC.get_config("seamless-m4t-large-v2"))
    jcfg = reduced_config(get_config("seamless-m4t-large-v2"))
    loader = PrefetchingLoader(cfg, seed=1, batch=2, seq=8, start_step=start_step)
    try:
        for i in range(3):
            step, batch = next(loader)
            assert step == start_step + i
            want = J.batch_at_step(jcfg, seed=1, step=step, host=0, n_hosts=1, batch=2, seq=8)
            for k in want:
                np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_elastic_device_counts_match_reference():
    for n, mp in ((512, 16), (100, 16), (8, 1), (4, 4), (3, 4)):
        assert elastic_device_counts(n, mp) == JF.elastic_device_counts(n, mp)


def test_watchdog_summary_keys_match_reference():
    ours, theirs = StepWatchdog(), JF.StepWatchdog()
    for wd in (ours, theirs):
        assert wd.summary() == {}
        wd.start()
        wd.stop()
    assert sorted(ours.summary()) == sorted(theirs.summary())


# -- the fault and data cases of tests/test_runtime.py, on the port ----------

def test_watchdog_flags_stragglers():
    wd = StepWatchdog(straggler_factor=3.0)
    for i in range(12):
        wd.start()
        time.sleep(0.02 if i != 10 else 0.2)
        wd.stop()
    assert 10 in wd.stragglers
    assert wd.summary()["stragglers"] >= 1


def test_watchdog_should_remesh():
    wd = StepWatchdog(straggler_factor=1.5, window=16)
    for i in range(16):
        wd.start()
        time.sleep(0.01 if i < 8 else 0.1)
        wd.stop()
    assert len(wd.stragglers) >= 5 and wd.should_remesh(patience=5)


def test_run_with_retries():
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientError("boom")

    retried = []
    run_with_retries(step, on_retry=lambda a, e: retried.append(a))
    assert calls["n"] == 3 and retried == [0, 1]

    def always_fails():
        raise TransientError("nope")

    with pytest.raises(TransientError):
        run_with_retries(always_fails, max_retries=1)


def test_run_with_retries_passes_other_errors():
    def fails():
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        run_with_retries(fails, on_retry=lambda a, e: pytest.fail("retried"))


def test_elastic_device_counts():
    assert elastic_device_counts(512, 16)[:3] == [512, 496, 480]
    assert all(n % 16 == 0 for n in elastic_device_counts(100, 16))


def test_data_determinism_and_resume():
    cfg = TC.reduced_config(TC.get_config("yi-6b"))
    b1 = batch_at_step(cfg, seed=3, step=7, host=0, n_hosts=1, batch=4, seq=16)
    b2 = batch_at_step(cfg, seed=3, step=7, host=0, n_hosts=1, batch=4, seq=16)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = batch_at_step(cfg, seed=3, step=8, host=0, n_hosts=1, batch=4, seq=16)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    # targets are next-token shifted
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])


def test_prefetching_loader_matches_pure_fn():
    cfg = TC.reduced_config(TC.get_config("yi-6b"))
    loader = PrefetchingLoader(cfg, seed=1, batch=2, seq=8, start_step=5)
    try:
        step, batch = next(loader)
        assert step == 5
        want = batch_at_step(cfg, seed=1, step=5, host=0, n_hosts=1, batch=2, seq=8)
        np.testing.assert_array_equal(batch["tokens"], want["tokens"])
    finally:
        loader.close()
