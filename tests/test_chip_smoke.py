"""A CPU rehearsal of every ``chip_smoke.py`` phase at a tiny size: the
paths, arguments, comparisons and output records the card run uses, with
the CPU backend standing in for the GPU."""

import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke_module():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def _rehearsal(cs):
    cpu = jax.devices("cpu")[0]
    return cs.Smoke(cpu, cpu, None)


PHASES = {
    "configs": lambda s, cs: s.configs_512(
        ["PyHSchunck_Fs3_4", "denseLK_Fs2_0", "Farneback_Fs0_0",
         "LiuSE_PyHSchunck_Fs3_4_PyrLvls2"], shape=(96, 96)),
    "oracle": lambda s, cs: s.oracle_512(shape=(96, 96)),
    "sizes": lambda s, cs: s.sizes([(label, name, (128, 96))
                                    for label, name, _ in cs.SIZE_CASES]),
    "entry_points": lambda s, cs: s.entry_points(shape=(96, 96), k=2),
    "four_cards": lambda s, cs: s.four_cards(jax.devices()[:4], k=4,
                                             small=(64, 64), big=(64, 64)),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_chip_smoke_phase_rehearsal(phase, smoke_module, capsys):
    """Each phase end to end on the CPU backend at a tiny size: paths,
    arguments, comparisons and output records."""
    smoke = _rehearsal(smoke_module)
    PHASES[phase](smoke, smoke_module)
    assert smoke.failures == []
    lines = capsys.readouterr().out.splitlines()
    assert lines and all('"passed": true' in ln for ln in lines)
