"""The port's fault injection and retry against the JAX package's.

One plan string fires the same faults at the same (site, key) in both
packages: the keyed decision is the same function of (seed, site, key),
the unkeyed per-site stream the same sequence, the `max` and `at` params
the same caps and pins; the crash-site sugar and a malformed environment
plan behave alike (a warning, nothing installed); the backoff sequences of
the retry policies are equal."""

import subprocess
import sys
from pathlib import Path

import pytest

from fabric_tpu.common import faults as jfaults
from fabric_tpu.common import retry as jretry
from fabric_tpu_torch.common import faults as tfaults
from fabric_tpu_torch.common import retry as tretry

REPO = Path(__file__).resolve().parent.parent
PLANS = [
    "batcher.dispatch=raise:0.3",
    "pipeline.commit=raise:0.5:max=4;batcher.submit=delay:0.2:ms=0",
    "kvledger.commit.post_block=raise:at=3",
    "blockstore.append.pre_fsync=raise:0.7:at=2:max=1,persistent.commit.mid=raise:0.25",
]
SITES = ("batcher.dispatch", "batcher.submit", "pipeline.commit", "kvledger.commit.post_block",
         "blockstore.append.pre_fsync", "persistent.commit.mid")


def _fired(mod, plan_text, seed, keyed):
    """[(site, key, action or None)] for every call of a fixed schedule."""
    plan = mod.FaultPlan.parse(plan_text, seed=seed)
    out = []
    for step in range(60):
        site = SITES[step % len(SITES)]
        key = step // len(SITES) if keyed else None
        spec = plan.check(site, key)
        out.append((site, key, None if spec is None else spec.action))
    return out, plan.fired()


@pytest.mark.parametrize("plan_text", PLANS)
@pytest.mark.parametrize("seed", [0, 7, 2026])
@pytest.mark.parametrize("keyed", [True, False])
def test_same_plan_fires_same_decisions(plan_text, seed, keyed):
    got = _fired(tfaults, plan_text, seed, keyed)
    assert got == _fired(jfaults, plan_text, seed, keyed)
    assert tfaults.FaultPlan.parse(plan_text).specs() == [
        tfaults.FaultSpec(**vars(s)) for s in jfaults.FaultPlan.parse(plan_text).specs()]


def test_fault_point_raises_and_plan_scopes():
    plan = tfaults.FaultPlan.parse("batcher.dispatch=raise")
    assert tfaults.fault_point("batcher.dispatch") is None
    with tfaults.plan_installed(plan):
        with pytest.raises(tfaults.InjectedFault, match="batcher.dispatch"):
            tfaults.fault_point("batcher.dispatch")
        assert tfaults.fault_point("pipeline.commit") is None
    assert tfaults.active_plan() is None
    assert issubclass(tfaults.InjectedFault, Exception)
    assert tfaults.InjectedFault in tretry.TRANSIENT_ERRORS


@pytest.mark.parametrize("text", ["nosuchsep", "a=explode", "a=raise:2.0", "a=raise:max=x",
                                  "a=raise:bogus=1", "=raise"])
def test_malformed_plans_raise_alike(text):
    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(text)
    with pytest.raises(ValueError):
        tfaults.FaultPlan.parse(text)


def test_crash_site_sugar_matches():
    text = "kvledger.commit.pre_pvt@3;persistent.commit.mid, blockstore.append.pre_index@0"
    assert [vars(s) for s in tfaults.crash_specs_from_text(text)] == [
        vars(s) for s in jfaults.crash_specs_from_text(text)]


_PROBE = r"""
import json, sys, warnings
sys.path.insert(0, sys.argv[1])
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    from fabric_tpu_torch.common import faults
plan = faults.active_plan()
print(json.dumps({"installed": None if plan is None else [vars(s) for s in plan.specs()],
                  "warned": [str(w.message) for w in caught]}))
"""


@pytest.mark.parametrize("env,installed,warned", [
    ({"FABRIC_TPU_FAULTS": "pipeline.commit=explode"}, None, True),
    ({"FABRIC_TPU_CRASH_SITES": "@3"}, None, True),
    ({"FABRIC_TPU_CRASH_SITES": "kvledger.commit.post_block@3", "FABRIC_TPU_FAULTS_SEED": "5"},
     [{"site": "kvledger.commit.post_block", "action": "kill", "prob": 1.0, "max_fires": 1,
       "delay_ms": 10, "lanes": 1, "at_key": 3}], False),
])
def test_environment_plan_at_import(env, installed, warned):
    import json
    import os

    clean = {k: v for k, v in os.environ.items() if not k.startswith("FABRIC_TPU_")}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(REPO)], env={**clean, **env},
                         capture_output=True, text=True, check=True, timeout=120)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["installed"] == installed
    assert bool(report["warned"]) == warned


def test_retry_policies_and_backoff_match():
    assert vars(tretry.DISPATCH_POLICY) == vars(jretry.DISPATCH_POLICY)
    policy = dict(base_s=0.01, multiplier=3.0, cap_s=0.2, deadline_s=1.0, jitter=0.5)
    slept = {"port": [], "jax": []}
    for label, mod in (("port", tretry), ("jax", jretry)):
        bo = mod.Backoff(mod.RetryPolicy(**policy), seed=11, sleeper=slept[label].append)
        while bo.sleep():
            pass
    assert slept["port"] == slept["jax"] and len(slept["port"]) >= 3
    calls = {"port": 0, "jax": 0}
    for label, mod in (("port", tretry), ("jax", jretry)):
        def fn(attempt, label=label):
            calls[label] += 1
            if attempt < 2:
                raise ConnectionError("flap")
            return attempt

        assert mod.call_with_retry(fn, sleeper=lambda s: None) == 2
    assert calls == {"port": 3, "jax": 3}


def test_cooldown_gate_matches():
    """CooldownGate opens for exponentially longer cooldowns on failures
    and closes on a success, on a fake clock, as the JAX package's does."""
    seen = {}
    for label, mod in (("port", tretry), ("jax", jretry)):
        now = [0.0]
        gate = mod.CooldownGate(mod.RetryPolicy(base_s=0.5, multiplier=2.0, cap_s=3.0,
                                                deadline_s=float("inf")), clock=lambda: now[0])
        trace = []
        for step in range(12):
            trace.append(gate.ready())
            if step in (0, 2, 3, 6, 7, 8):
                gate.record_failure()
            if step == 10:
                gate.record_success()
            now[0] += 0.75
        seen[label] = trace
    assert seen["port"] == seen["jax"] and False in seen["port"]
