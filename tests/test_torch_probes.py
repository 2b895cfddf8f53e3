"""PyTorch port: the kernel probes (``tools/attention_fwd_probe.py``,
``tools/attention_bwd_probe.py``, ``tools/lstm_probe.py``) rewrite a
kernel's ``// probe:`` comments into ``clock64()`` stamps and build it
beside copies of the headers it includes. These tests hold the rewrite and the copied header
set against the shipped sources on the CPU, so a core edited without its
probe fails here rather than in a chip run."""

import re

import pytest

from deeplearning4j_tpu_torch.kernels import cuda_lib
from deeplearning4j_tpu_torch.tools import attention_bwd_probe as bwd
from deeplearning4j_tpu_torch.tools import attention_fwd_probe as fwd
from deeplearning4j_tpu_torch.tools import lstm_probe


def _source(name):
    return (cuda_lib.CSRC / name).read_text()


def _includes(name, seen=None):
    """Every repository header ``name`` includes, transitively."""
    seen = set() if seen is None else seen
    for inc in re.findall(r'#include "([^"]+)"', _source(name)):
        if inc not in seen:
            seen.add(inc)
            _includes(inc, seen)
    return seen


def test_bwd_probe_copies_every_header_the_core_includes():
    assert _includes("attention_bwd_core.cuh") == set(bwd.HEADERS)


def test_fwd_probe_copies_every_header_the_core_includes():
    copied = set(re.findall(r'"(\w+\.cuh)"', open(fwd.__file__).read()))
    assert _includes("attention_fwd_core.cuh") <= copied


@pytest.mark.parametrize("role", bwd.ROLES)
def test_bwd_probe_stamps_every_phase_of_each_role(role):
    """Each role of the backward core opens its counters once, marks every
    phase but the prologue once, and adds its counters to its own row of
    the device array once; no probe comment survives the rewrite."""
    core = _source("attention_bwd_core.cuh")
    marks = re.findall(r"// probe: (\w+)(?: (\w+))?", core)
    begin = [i for i, (name, _) in enumerate(marks) if name == "begin"]
    done = [i for i, m in enumerate(marks) if m == ("done", role)]
    assert len(begin) == len(bwd.ROLES) and len(done) == 1
    start = max(i for i in begin if i < done[0])
    phases = [name for name, _ in marks[start + 1:done[0]]]
    assert sorted(phases) == sorted(p for p in bwd.PHASES if p != "prologue")
    out = bwd.instrumented(core)
    assert "// probe:" not in out
    row = bwd.ROLES.index(role) * len(bwd.PHASES)
    assert out.count(f"&g_probe[{row} + k_]") == 1


def test_fwd_probe_stamps_every_phase():
    core = _source("attention_fwd_core.cuh")
    names = set(re.findall(r"// probe: (\w+)", core))
    assert names <= set(fwd.PHASES) | {"done"}
    out = fwd._instrumented(core)
    assert "// probe:" not in out and out.count("atomicAdd") == 1


def test_lstm_probe_copies_every_header_the_kernel_includes():
    assert _includes("lstm.cu") == set(lstm_probe.HEADERS)


def test_lstm_probe_stamps_every_phase():
    """The cluster kernel opens its counters once, marks every phase but
    the prologue once, and adds its counters to the device array once,
    after the stamps' definitions; no probe comment survives."""
    src = _source("lstm.cu")
    marks = re.findall(r"// probe: (\w+)", src)
    assert marks.count("begin") == 1 and marks.count("done") == 1
    assert sorted(m for m in marks if m not in ("begin", "done")) == \
        sorted(p for p in lstm_probe.PHASES if p != "prologue")
    out = lstm_probe.instrumented(src)
    assert "// probe:" not in out and out.count("atomicAdd") == 1
    assert out.index("#define PROBE_MARK") < out.index("PROBE_MARK(0)")
