"""The port's schedule-as-data planners, microbatch calculators and
samplers (``apex_tpu_torch.transformer.pipeline_parallel.schedules``,
``transformer.microbatches``, ``transformer.data``) against the JAX
package's, with no ranks: every plan slot for slot and its arrays element
for element over every planner on a grid of M in 1..8, S in 1..4 and vpp
in {1, 2}; the plans' bubble against the closed-form floors of
``apex_tpu.monitor.tracing.expected_bubble_fraction``
(``tests/test_tracing.py:131``, ``:160``); the tick count and the
interleaved stack; the calculators; and the six cases of
``tests/test_batch_sampler.py``, whose index streams equal the reference's
element for element.
"""

import math

import numpy as np
import pytest
import torch

from apex_tpu.monitor.tracing import expected_bubble_fraction
from apex_tpu.transformer import data as jdata
from apex_tpu.transformer import microbatches as jmb
from apex_tpu.transformer.pipeline_parallel import schedules as jsched
from apex_tpu_torch.transformer import data, microbatches
from apex_tpu_torch.transformer.pipeline_parallel import schedules

GRID = [(name, M, S, vpp) for name in schedules.PLANNERS
        for M in range(1, 9) for S in range(1, 5) for vpp in (1, 2)
        if vpp == 1 or name == "interleaved"]


def _plan(mod, name, M, S, vpp):
    try:
        return mod.plan_schedule(name, M, S, vpp)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("name", schedules.PLANNERS)
def test_plans_equal_the_jax_planner_slot_for_slot(name):
    for _, M, S, vpp in [g for g in GRID if g[0] == name]:
        got, want = _plan(schedules, name, M, S, vpp), _plan(
            jsched, name, M, S, vpp)
        if isinstance(want, tuple):
            assert got == want, (name, M, S, vpp)
            continue
        assert (got.schedule, got.stages, got.num_microbatches,
                got.virtual_pipeline_size) == (
            want.schedule, want.stages, want.num_microbatches,
            want.virtual_pipeline_size)
        assert [[(s.kind, s.microbatch, s.chunk) for s in row]
                for row in got.ranks] == [
            [(s.kind, s.microbatch, s.chunk) for s in row]
            for row in want.ranks], (name, M, S, vpp)
        a, b = got.arrays(), want.arrays()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert got.idle_slots() == want.idle_slots()
        assert got.bubble_fraction() == want.bubble_fraction()


def test_plan_aliases_and_errors_match():
    for alias in ("zerobubble", "zb", "1f1b-interleaved", "vpp", "ZERO_BUBBLE"):
        assert (schedules.plan_schedule(alias, 4, 2).schedule
                == jsched.plan_schedule(alias, 4, 2).schedule)
    for args in (("mystery", 4, 2), ("1f1b", 0, 2), ("1f1b", 4, 2, 2),
                 ("interleaved", 3, 2, 2)):
        with pytest.raises(ValueError) as got:
            schedules.plan_schedule(*args)
        with pytest.raises(ValueError) as want:
            jsched.plan_schedule(*args)
        assert str(got.value) == str(want.value)


def test_schedule_plans_meet_closed_form_floors():
    for sched in ("gpipe", "1f1b", "zero-bubble"):
        for S in (2, 3, 4):
            for M in (S, 4, 8):
                if M < S:
                    continue
                plan = schedules.plan_schedule(sched, M, S)
                assert math.isclose(plan.bubble_fraction(),
                                    expected_bubble_fraction(sched, M, S))
                assert plan.ticks == (3 * M + S - 1 if sched == "zero-bubble"
                                      else 2 * (M + S - 1))
    for vpp in (1, 2):
        plan = schedules.plan_schedule("interleaved", 4, 4, vpp)
        assert plan.ticks == 2 * schedules.pipeline_tick_count(4, 4, vpp)
        assert math.isclose(plan.bubble_fraction(), expected_bubble_fraction(
            "interleaved", 4, 4, vpp))


def test_tick_count_and_ring_arrays():
    S, M, vpp = 4, 4, 2
    assert schedules.pipeline_tick_count(M, S, vpp) == vpp * M + S - 1 == 11
    assert schedules.pipeline_tick_count(M, S, vpp) < vpp * (M + S - 1)
    for M, S, vpp in ((4, 4, 2), (3, 2, 1), (8, 4, 2), (2, 1, 1)):
        got = schedules._ring_plan_arrays(M, S, vpp)
        want = jsched._ring_plan_arrays(M, S, vpp)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_interleave_stack_round_trip(as_tensor):
    w = np.arange(8.0)[:, None] * np.ones((8, 3))
    layers = {"w": torch.from_numpy(w) if as_tensor else w, "b": {"x": w}}
    perm = schedules.interleave_stack(layers, 2, 2)
    np.testing.assert_array_equal(np.asarray(perm["w"][:, 0]),
                                  [0, 1, 4, 5, 2, 3, 6, 7])
    np.testing.assert_array_equal(
        np.asarray(perm["b"]["x"]),
        np.asarray(jsched.interleave_stack({"x": w}, 2, 2)["x"]))
    back = schedules.deinterleave_stack(perm, 2, 2)
    np.testing.assert_array_equal(np.asarray(back["w"]), w)
    assert schedules.stage_layer_ids(8, 2, 2, 1) == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="pp\\*vpp"):
        schedules.interleave_stack({"w": w[:6]}, 2, 2)


def test_pipeline_specs_names_pipe_on_the_layer_dim():
    specs = {"qkv": {"kernel": (None, None, "model"), "bias": (None, "model")},
             "ln1": {"scale": (None, None)}}
    assert schedules.pipeline_specs(specs) == {
        "qkv": {"kernel": ("pipe", None, "model"), "bias": ("pipe", "model")},
        "ln1": {"scale": ("pipe", None)}}


def test_microbatch_calculators_match_the_reference():
    for mod in (microbatches, jmb):
        c = mod.build_num_microbatches_calculator(64, 4, 2)
        assert c.get() == 8
        with pytest.raises(ValueError):
            mod.build_num_microbatches_calculator(63, 4, 2)
    got = microbatches.build_num_microbatches_calculator(
        64, 4, 2, rampup_batch_size=[16, 16, 300])
    want = jmb.build_num_microbatches_calculator(
        64, 4, 2, rampup_batch_size=[16, 16, 300])
    assert isinstance(got, microbatches.RampupBatchsizeNumMicroBatches)
    for consumed in (0, 50, 99, 100, 150, 199, 200, 250, 299, 300, 400):
        got.update(consumed, False)
        want.update(consumed, False)
        assert (got.get(), got.get_current_global_batch_size()) == (
            want.get(), want.get_current_global_batch_size()), consumed
    for mod in (microbatches, jmb):
        odd = mod.build_num_microbatches_calculator(
            64, 4, 2, rampup_batch_size=[16, 12, 300])
        with pytest.raises(RuntimeError):
            odd.update(100, True)


# -- the six cases of tests/test_batch_sampler.py, each stream against the
# -- reference's element for element


def _same_stream(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return got


def test_pretraining_sampler_disjoint_cover():
    total, mbs, dp = 32, 2, 4
    per_rank = [_same_stream(
        data.MegatronPretrainingSampler(total, 0, mbs, r, dp),
        jdata.MegatronPretrainingSampler(total, 0, mbs, r, dp))
        for r in range(dp)]
    for step in range(total // (mbs * dp)):
        merged = np.concatenate([per_rank[r][step] for r in range(dp)])
        np.testing.assert_array_equal(
            merged, np.arange(step * mbs * dp, (step + 1) * mbs * dp))


def test_pretraining_sampler_resume_and_drop_last():
    kw = dict(consumed_samples=4, micro_batch_size=2, data_parallel_rank=0,
              data_parallel_size=2, drop_last=False)
    batches = _same_stream(data.MegatronPretrainingSampler(10, **kw),
                           jdata.MegatronPretrainingSampler(10, **kw))
    np.testing.assert_array_equal(batches[0], [4, 5])
    np.testing.assert_array_equal(batches[-1], [8, 9])


def test_pretraining_sampler_validation():
    for args in ((0, 0, 2, 0, 1), (8, 8, 2, 0, 1), (8, 0, 2, 3, 2)):
        with pytest.raises(RuntimeError):
            data.MegatronPretrainingSampler(*args)


def test_random_sampler_epoch_determinism_and_disjoint():
    total, mbs, dp = 64, 4, 2
    a0 = _same_stream(data.MegatronPretrainingRandomSampler(total, 0, mbs, 0,
                                                            dp),
                      jdata.MegatronPretrainingRandomSampler(total, 0, mbs,
                                                             0, dp))
    r1 = _same_stream(data.MegatronPretrainingRandomSampler(total, 0, mbs, 1,
                                                            dp),
                      jdata.MegatronPretrainingRandomSampler(total, 0, mbs,
                                                             1, dp))
    seen0 = set(np.concatenate(a0).tolist())
    assert not seen0 & set(np.concatenate(r1).tolist())
    assert len(seen0) == total // dp


def test_random_sampler_resume_skips_consumed():
    total, mbs, dp = 64, 4, 2
    full = list(data.MegatronPretrainingRandomSampler(total, 0, mbs, 0, dp))
    resumed = _same_stream(
        data.MegatronPretrainingRandomSampler(total, 16, mbs, 0, dp),
        jdata.MegatronPretrainingRandomSampler(total, 16, mbs, 0, dp))
    for x, y in zip(full[2:], resumed):
        np.testing.assert_array_equal(x, y)
    # a later epoch's permutation too
    _same_stream(
        data.MegatronPretrainingRandomSampler(total, 80, mbs, 1, dp),
        jdata.MegatronPretrainingRandomSampler(total, 80, mbs, 1, dp))


def test_get_kth_microbatch():
    batch = {"x": np.arange(12).reshape(6, 2), "y": np.arange(6)}
    mb = data.get_kth_microbatch(batch, 1, 3)
    np.testing.assert_array_equal(mb["y"], [2, 3])
    np.testing.assert_array_equal(mb["x"], [[4, 5], [6, 7]])
    t = data.get_kth_microbatch([torch.arange(6)], 2, 3)
    assert t[0].tolist() == [4, 5]
    with pytest.raises(ValueError):
        data.get_kth_microbatch(batch, 3, 3)
    with pytest.raises(ValueError):
        data.get_kth_microbatch(batch, 0, 4)
