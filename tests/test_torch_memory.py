"""The port's Memory against the JAX package's, case by case.

Each of the nine cases of tests/test_memory.py runs one sequence of adds and
prepares on both packages' Memory (with each package's MemoryConfig and
bucket_size) and asserts what the original case asserts on each. Then every
array and counter of the two memories, and every view the case reads, must
be exactly equal: both are the same numpy arithmetic.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from gpmpc_tpu.config import configs as jconfigs
from gpmpc_tpu.memory import buffer as jbuffer
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.config import configs as tconfigs
from gpmpc_tpu_torch.memory import buffer as tbuffer

PACKAGES = {
    "jax": SimpleNamespace(Memory=jbuffer.Memory, MemoryConfig=jconfigs.MemoryConfig, bucket_size=jbuffer.bucket_size),
    "torch": SimpleNamespace(Memory=tbuffer.Memory, MemoryConfig=tconfigs.MemoryConfig,
                             bucket_size=tbuffer.bucket_size),
}


def make_memory(pkg, ns=2, na=1, step=1, check=True, cap=16):
    cfg = pkg.MemoryConfig(
        check_errors_for_storage=check,
        min_error_prediction_state_for_memory=[1e-2] * ns,
        min_prediction_state_std_for_memory=[1e-2] * ns,
        points_batch_memory=cap,
    )
    return pkg.Memory(cfg, dim_input=ns + na, dim_state=ns, step_model=step)


def empty_memory_dummy_point(pkg):
    mem = make_memory(pkg)
    x, y = mem.get()
    assert x.shape == (1, 3) and y.shape == (1, 2)
    assert np.all(x == 0) and np.all(y == 0)
    return [mem], [x, y]


def targets_are_state_changes(pkg):
    mem = make_memory(pkg, check=False)
    states = [np.array([0.1 * i, 0.2 * i]) for i in range(5)]
    for i in range(4):
        mem.add(states[i], np.array([0.5]), states[i + 1], reward=0.0, iter_ctrl=i)
    mem.prepare_for_model()
    x, y = mem.get()
    assert len(x) == 4
    np.testing.assert_allclose(y, np.array([states[i + 1] - states[i] for i in range(4)]))
    np.testing.assert_allclose(x[:, :2], np.array(states[:4]))
    np.testing.assert_allclose(x[:, 2], 0.5)
    return [mem], [x, y]


def step_model_target_offset(pkg):
    k = 3
    mem = make_memory(pkg, check=False, step=k)
    states = [np.array([float(i), 0.0]) for i in range(10)]
    for i in range(9):
        mem.add(states[i], np.array([0.5]), states[i + 1], reward=0.0, iter_ctrl=i)
    mem.prepare_for_model()
    x, y = mem.get()
    np.testing.assert_allclose(x[:, 0], [0.0, 3.0, 6.0])
    np.testing.assert_allclose(y[:, 0], [3.0, 3.0, 3.0])
    return [mem], [x, y, mem.get_memory_total()[0], mem.get_memory_total()[1], mem.get_mask_model_inputs()]


def storage_filter_and_semantics(pkg):
    mem = make_memory(pkg, check=True)
    s = np.zeros(2)
    s2 = np.ones(2) * 0.5
    big_err = np.array([1.0, 1.0])
    small_std = np.array([1e-5, 1e-5])
    big_std = np.array([1.0, 1.0])
    mem.add(s, np.array([0.5]), s2, 0.0, 0, predicted_state=s2 + big_err, predicted_state_std=small_std)
    mem.add(s, np.array([0.5]), s2, 0.0, 1, predicted_state=s2 + big_err, predicted_state_std=big_std)
    mem.add(s, np.array([0.5]), s2, 0.0, 2, predicted_state=s2, predicted_state_std=big_std)
    mem.add(s, np.array([0.5]), s2, 0.0, 3)
    mem.prepare_for_model()
    x, y = mem.get()
    assert len(x) == 2
    assert mem.active_data_mask[:4].tolist() == [False, True, False, True]
    return [mem], [x, y]


def growth_beyond_capacity(pkg):
    mem = make_memory(pkg, check=False, cap=4)
    for i in range(10):
        mem.add(np.array([i * 0.1, 0.0]), np.array([0.5]), np.array([(i + 1) * 0.1, 0.0]), 0.0, i)
    mem.prepare_for_model()
    x, y = mem.get()
    assert len(x) == 10
    assert len(mem.inputs) == 12 and len(mem.model_inputs) == 12  # three chunks of 4
    return [mem], [x, y]


def deferred_processing(pkg):
    mem = make_memory(pkg, check=False)
    mem.add(np.zeros(2), np.array([0.5]), np.ones(2) * 0.1, 0.0, 0)
    mem.prepare_for_model()
    assert len(mem.get()[0]) == 1
    mem.add(np.ones(2) * 0.1, np.array([0.5]), np.ones(2) * 0.2, 0.0, 1)
    views = [mem.get()[0]]
    assert len(views[0]) == 1  # not yet processed
    mem.prepare_for_model()
    assert len(mem.get()[0]) == 2
    return [mem], views + list(mem.get())


def time_feature_column(pkg):
    mem = pkg.Memory(pkg.MemoryConfig(check_errors_for_storage=False, points_batch_memory=8), dim_input=4,
                     dim_state=2, include_time_model=True, step_model=1)
    mem.add(np.zeros(2), np.array([0.5]), np.ones(2) * 0.1, 0.0, iter_ctrl=7)
    mem.prepare_for_model()
    x, _ = mem.get()
    assert x[0, -1] == 7.0
    return [mem], [x]


def padded_view_buckets(pkg):
    sizes = [1, 32, 33, 300, 1500, 2500]
    buckets = [pkg.bucket_size(n) for n in sizes]
    assert buckets == [32, 32, 64, 384, 1536, 2560]
    mem = make_memory(pkg, check=False)
    mem.add(np.zeros(2), np.array([0.5]), np.ones(2) * 0.1, 0.0, 0)
    mem.prepare_for_model()
    x_pad, y_pad, mask, b = mem.get_padded()
    assert x_pad.shape == (32, 3) and mask.sum() == 1
    return [mem], [np.asarray(buckets), x_pad, y_pad, mask, np.asarray(b)]


def misaligned_prepare_loses_no_points(pkg):
    step = 3
    n_total = 17

    def transition(i):
        return np.array([0.01 * i, -0.01 * i]), np.array([0.5]), np.array([0.01 * (i + 1), -0.01 * (i + 1)])

    gold = make_memory(pkg, step=step, check=False, cap=32)
    for i in range(n_total):
        s, a, s2 = transition(i)
        gold.add(s, a, s2, reward=0.0, iter_ctrl=i)
    gold.prepare_for_model()
    gx, gy = gold.get()

    mem = make_memory(pkg, step=step, check=False, cap=32)
    for i in range(n_total):
        s, a, s2 = transition(i)
        mem.add(s, a, s2, reward=0.0, iter_ctrl=i)
        if i in (3, 6, 10, 15):
            mem.prepare_for_model()
    mem.prepare_for_model()
    x, y = mem.get()
    assert mem.len_mem_last_processed % step == 0
    np.testing.assert_array_equal(x, gx)
    np.testing.assert_array_equal(y, gy)
    return [gold, mem], [gx, gy, x, y]


CASES = [empty_memory_dummy_point, targets_are_state_changes, step_model_target_offset,
         storage_filter_and_semantics, growth_beyond_capacity, deferred_processing, time_feature_column,
         padded_view_buckets, misaligned_prepare_loses_no_points]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_memory_matches_jax(case):
    jmems, jviews = case(PACKAGES["jax"])
    tmems, tviews = case(PACKAGES["torch"])
    for jm, tm in zip(jmems, tmems, strict=True):
        js, ts = convert.memory_state(jm), convert.memory_state(tm)
        assert js.keys() == ts.keys()
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
            assert np.asarray(ts[k]).dtype == np.asarray(js[k]).dtype, k
    for jv, tv in zip(jviews, tviews, strict=True):
        np.testing.assert_array_equal(tv, jv)


def test_load_memory_carries_a_jax_memory_across():
    """convert.load_memory puts a port Memory in a JAX Memory's state, and
    both then evolve alike."""
    jm = make_memory(PACKAGES["jax"], check=True, step=2, cap=4)
    rng = np.random.default_rng(0)
    for i in range(7):
        jm.add(rng.uniform(0, 1, 2), rng.uniform(0, 1, 1), rng.uniform(0, 1, 2), 0.1 * i, i,
               predicted_state=rng.uniform(0, 1, 2), predicted_state_std=rng.uniform(0, 0.05, 2))
    jm.prepare_for_model()
    tm = convert.load_memory(make_memory(PACKAGES["torch"], check=True, step=2, cap=4), **convert.memory_state(jm))
    for m in (jm, tm):
        m.add(np.full(2, 0.3), np.full(1, 0.2), np.full(2, 0.4), 1.0, 7, predicted_state=np.full(2, 0.9),
              predicted_state_std=np.full(2, 0.5))
        m.prepare_for_model()
    js, ts = convert.memory_state(jm), convert.memory_state(tm)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    for a, b in zip(tm.get_padded(), jm.get_padded()):
        np.testing.assert_array_equal(a, b)
