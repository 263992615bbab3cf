"""The import check: what the harness and the reference load, compared by
whole top-level module names. Nothing of jax, jaxlib, flax, optax, orbax or
the JAX package (`visual_onoma_to_wave_tpu`) in a run's process; the
reference loads nothing of the port (`visual_onoma_to_wave_tpu_torch`)
either. Each check runs in a fresh interpreter."""
from __future__ import annotations

import subprocess
import sys

import pytest

from conftest import BENCH, REPO

PRELUDE = f"""
import sys
sys.path[:0] = [{str(REPO)!r}, {str(BENCH)!r}]
from pbcore import spec
"""


def loaded_after(code: str, extra: tuple = ()) -> list[str]:
    script = PRELUDE + code + f"\nprint(spec.forbidden_loaded({extra!r}))\n"
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_reference_and_yardstick_load_neither_jax_nor_the_port():
    code = """
for p in (spec.BENCH / "reference").glob("*.py"):
    spec.load_module(p, "pbref_" + p.stem)
from pbcore import costs, judge, lowp, traffic, weights, trace
for p in (spec.BENCH / "drivers").glob("*.py"):
    spec.load_module(p, "pbdriver_" + p.stem)
for p in (spec.BENCH / "metrics").glob("*.py"):
    spec.load_module(p, "pbmetric_" + p.stem.replace(".", "_"))
"""
    assert loaded_after(code, ("visual_onoma_to_wave_tpu_torch",)) == []


def test_a_run_loads_no_jax():
    """Everything a run imports: the harness, every driver and reader, and
    the port's modules a run reaches."""
    code = """
import run
from pbcore import program
for p in sorted((spec.BENCH / "drivers").glob("*.py")):
    spec.load_module(p, "pbdriver_" + p.stem)
import visual_onoma_to_wave_tpu_torch.synthesis, visual_onoma_to_wave_tpu_torch.models
import visual_onoma_to_wave_tpu_torch.ops.cuda_build
"""
    assert loaded_after(code) == []


@pytest.mark.parametrize("name,expected", [("jax.numpy", ["jax.numpy"]),
                                           ("visual_onoma_to_wave_tpu.ops", ["visual_onoma_to_wave_tpu.ops"]),
                                           ("visual_onoma_to_wave_tpu_torch.ops", [])])
def test_names_are_compared_whole(name, expected):
    from pbcore import spec

    sys.modules[name] = type(sys)(name)
    try:
        assert [m for m in spec.forbidden_loaded() if m == name] == expected
    finally:
        del sys.modules[name]
