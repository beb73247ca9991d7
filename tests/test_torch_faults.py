"""Copy parity, fault plans: the port's ``resilience/faults.py`` is the JAX
package's, kept whole (standard library only), so one ``REPRO_FAULT_PLAN``
arms both.  The two modules' code is the same statement for statement (the
module docstring aside), and both parse, serialise, refuse and answer every
site alike."""
import ast
import inspect
import json

import pytest

import repro.resilience.faults as jfaults
import repro_torch.resilience.faults as tfaults

PLANS = [
    None,
    "",
    {},
    {"serve_worker_fault": {}},
    {"serve_worker_fault": {"worker": 1}},
    json.dumps({"crash_at_step": {"step": 3, "mode": "raise", "process": 1},
                "slow_collate": {"sleep_s": 0.0}}),
    {"hang_at_step": {"step": 2, "hang_s": 0.0}, "drop_heartbeat": {"step": 4},
     "corrupt_checkpoint_payload": {"step": 5, "process": 0}},
]
BAD_PLANS = ["{not json", "[1, 2]", {"no_such_site": {}}, {"serve_worker_fault": 3}]


def _body(module):
    tree = ast.parse(inspect.getsource(module))
    tree.body = tree.body[1:]  # the module docstring
    return ast.dump(tree)


def test_the_copy_is_the_reference_module():
    assert _body(tfaults) == _body(jfaults)
    assert tfaults.SITES == jfaults.SITES
    assert (tfaults.ENV_FAULT_PLAN, tfaults.EXIT_CRASH) == (
        jfaults.ENV_FAULT_PLAN, jfaults.EXIT_CRASH)


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_parse_and_env_round_trip_agree(plan):
    spec = PLANS[plan]
    t, j = tfaults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert t.specs == j.specs and bool(t) == bool(j)
    assert t.to_env() == j.to_env()
    assert tfaults.FaultPlan.parse(t.to_env()) == t
    assert tfaults.FaultPlan.from_env({"REPRO_FAULT_PLAN": j.to_env()}) == t


@pytest.mark.parametrize("plan", range(len(BAD_PLANS)))
def test_both_refuse_a_bad_plan_alike(plan):
    with pytest.raises(ValueError) as t_err:
        tfaults.FaultPlan.parse(BAD_PLANS[plan])
    with pytest.raises(ValueError) as j_err:
        jfaults.FaultPlan.parse(BAD_PLANS[plan])
    assert str(t_err.value) == str(j_err.value)


def _answers(mod, spec):
    """Every site's answer under one plan, for steps 0-5, processes
    None/0/1 and workers None/0/1 (crash_at_step in raise mode only)."""
    plan = mod.FaultPlan.parse(spec)
    out = []
    for proc in (None, 0, 1):
        for step in range(6):
            try:
                plan.crash_at_step(step, process=proc)
                out.append(("crash", step, proc, None))
            except mod.SimulatedCrash as exc:
                out.append(("crash", step, proc, str(exc)))
            plan.hang_at_step(step, process=proc)
            out.append(("corrupt", step, proc,
                        plan.corrupt_checkpoint_payload(step, process=proc)))
            out.append(("heartbeat", step, proc, plan.drop_heartbeat(step, process=proc)))
        out.append(("slow", proc, plan.slow_collate(process=proc)))
    for worker in (None, 0, 1):
        out.append(("serve", worker, plan.serve_worker_fault(worker=worker)))
    return out


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_every_site_answers_alike(plan):
    spec = PLANS[plan]
    if "crash_at_step" in str(spec):
        assert '"mode": "raise"' in str(spec)  # an exit-mode crash would end the test
    assert _answers(tfaults, spec) == _answers(jfaults, spec)


def test_corrupt_file_flips_the_same_bytes(tmp_path):
    payload = bytes(range(256)) * 3
    for mod in (tfaults, jfaults):
        (tmp_path / mod.__name__).write_bytes(payload)
    assert (tfaults.corrupt_file(str(tmp_path / tfaults.__name__), n_bytes=40)
            == jfaults.corrupt_file(str(tmp_path / jfaults.__name__), n_bytes=40) == 40)
    assert ((tmp_path / tfaults.__name__).read_bytes()
            == (tmp_path / jfaults.__name__).read_bytes() != payload)
