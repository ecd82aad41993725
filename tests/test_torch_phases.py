"""The phase cuts of ``fgnn_tpu_torch.utils.phases``, on the CPU.

The tool builds the kernel sources once for each cut of a phase and times
the builds on the card; here each cut is held to the shipped sources: every
text it replaces is found exactly once, so that a cut does what it says.
"""

import os

import pytest

from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.utils import phases

BUILDS = [(name, build) for name, builds in phases.CUTS.items()
          for build in builds]


def _source(name):
    with open(os.path.join(fused_mp._CSRC, f"{name}.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name,build", BUILDS,
                         ids=[f"{n}-{b}" for n, b in BUILDS])
def test_each_cut_finds_its_texts_once_in_the_shipped_source(name, build):
    text = _source(name)
    cut = phases.cut_source(text, phases.CUTS[name][build])
    assert cut != text
    for old, new in phases.CUTS[name][build]:
        assert text.count(old) == 1


def test_a_cut_of_a_missing_text_raises():
    with pytest.raises(ValueError, match="found 0 times"):
        phases.cut_source("int x;", [("int y;", "")])
    with pytest.raises(ValueError, match="found 2 times"):
        phases.cut_source("a a", [("a", "b")])


def test_every_cut_source_has_a_design_entry():
    assert set(phases.CUTS) == set(phases.ENTRY)
    for entry in phases.ENTRY.values():
        assert entry in fused_mp._ARGTYPES
