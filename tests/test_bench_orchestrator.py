"""bench.py orchestration machinery.

The measurement sections need the card, but the orchestrator's contract --
child-process isolation, hard timeouts, metric dedupe across retries, device
sections that refuse to run without a GPU -- is testable on the CPU."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402

_CPU_ENV = {"JAX_PLATFORMS": "cpu"}


def test_decoders_section_child_and_dedupe():
    seen: set = set()
    ok, lines, tail = bench._run_section_child(
        "decoders", timeout_s=600, env_extra=_CPU_ENV, seen_metrics=seen)
    assert ok, tail
    metrics = [json.loads(l)["metric"] for l in lines]
    assert len(metrics) >= 6 and len(set(metrics)) == len(metrics)
    assert seen == set(metrics)
    # A retry re-measures but must not re-emit already-streamed metrics:
    # emitted lines are still collected, the seen set stays fixed.
    ok2, lines2, _ = bench._run_section_child(
        "decoders", timeout_s=600, env_extra=_CPU_ENV, seen_metrics=seen)
    assert ok2 and len(lines2) == len(lines)
    assert seen == set(metrics)


def test_hung_child_is_killed_not_wedged():
    # A child still running at its hard timeout is killed, and the
    # orchestrator returns instead of waiting on it: the decoders section
    # takes far longer than one second.
    import time

    t0 = time.time()
    ok, lines, tail = bench._run_section_child(
        "decoders", timeout_s=1, env_extra=_CPU_ENV)
    assert time.time() - t0 < 60
    assert not ok
    assert "timeout after 1s" in tail


@pytest.mark.parametrize("section", ["headline", "edit"])
def test_device_section_fails_without_gpu(section):
    """A device section on the CPU exits non-zero before measuring: no
    number from another backend can pass for a card number."""
    ok, lines, tail = bench._run_section_child(
        section, timeout_s=300, env_extra=_CPU_ENV)
    assert not ok
    assert not lines
    assert "no GPU" in tail
