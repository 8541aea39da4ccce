"""chip_smoke.py's phase selection and its refusal to report without a
GPU (the phases themselves run on the card)."""

import argparse

import jax
import pytest

import chip_smoke


def _args(**kw):
    base = dict(multi=False, phases="abcd", rehearse_cpu=False)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("phases,want", [
    ("abcd", ["device", "kernels", "drift", "apps"]),
    ("b", ["device", "kernels"]),
    ("d", ["device", "apps"]),
    ("", ["device"]),
])
def test_phase_selection(phases, want):
    assert chip_smoke.phases_for(_args(phases=phases)) == want


def test_multi_runs_only_its_phase():
    # --multi ignores --phases: the 4-card comparison and nothing else
    assert chip_smoke.phases_for(_args(multi=True)) == ["device", "multi"]
    assert chip_smoke.phases_for(
        _args(multi=True, phases="bcd")) == ["device", "multi"]


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.phase_device()


def test_main_on_cpu_fails_without_ok_line(capsys):
    before = jax.config.jax_compilation_cache_dir
    try:
        with pytest.raises(RuntimeError, match="needs a GPU"):
            chip_smoke.main([])
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert '"ok"' not in capsys.readouterr().out
