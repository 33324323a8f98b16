"""The comparison that decides ``correct`` fails its control and the
faults a cell can have, at a size a test run holds: the harness's look for
a card is skipped and the rest of a run is driven on the CPU."""

import time

import pytest
import torch

from portbench import harness
from cells import small_names, tree

GRID, MESH = small_names("grid"), small_names("mesh")
# the precision below each configuration's: (arithmetic, storage)
CONTROL = {"grid": (torch.float32, torch.bfloat16), "mesh": (torch.float32, None)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tree(str(tmp_path_factory.mktemp("bench")), 16, 1)


def _run(root, cell, **kw):
    return harness.run(root, cell, 2**31 + 5, 0.2, False, "cpu", time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", GRID + MESH)
def test_control_fails(root, cell):
    """The reference in the precision below the configuration's, in the
    program's place."""
    out = _run(root, cell, control=CONTROL["grid" if cell in GRID else "mesh"])
    assert not out["correct"]
    assert out["checks"]["state_gap"]["value"] > 3 * out["checks"]["state_gap"]["limit"]


def _step_name(cell):
    return "step_deferred" if cell in GRID else "step"


@pytest.mark.parametrize("cell", GRID + MESH)
def test_step_that_returns_its_state_fails(root, cell, monkeypatch):
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    real = getattr(MGMCSampler, _step_name(cell))
    if cell in GRID:
        def stuck(self, key, xpy, z, b):
            key2, _, _, sx, zs = real(self, key, xpy, z, b)
            return key2, xpy, z, sx, zs
    else:
        def stuck(self, key, x, b, aux=None):
            return real(self, key, x, b, aux)[0], x

    monkeypatch.setattr(MGMCSampler, _step_name(cell), stuck)
    assert not _run(root, cell)["correct"]


@pytest.mark.parametrize("cell", GRID + MESH)
def test_answer_altered_where_produced_fails(root, cell, monkeypatch):
    """The sample nudged by 1 % where it is made: the level-0 chain
    function's output (grid), the step's (mesh)."""
    from parmgmc_tpu_torch.kernels import mg_sweep
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    if cell in GRID:
        real = mg_sweep.fused_chain_down_fd

        def nudged(*a, **k):
            out = real(*a, **k)
            out[0].mul_(1.01)
            return out

        monkeypatch.setattr(mg_sweep, "fused_chain_down_fd", nudged)
    else:
        real = MGMCSampler.step
        monkeypatch.setattr(MGMCSampler, "step", lambda self, *a, **k: (
            (lambda r: (r[0], r[1] * 1.01))(real(self, *a, **k))))
    assert not _run(root, cell)["correct"]


@pytest.mark.parametrize("cell", [c for c in MESH if "chains" in c])
def test_half_the_chains_left_out_fails(root, cell, monkeypatch):
    """A step that advances the first half of the chain-major batch only."""
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

    real = MGMCSampler.step

    def half(self, key, x, b, aux=None):
        key2, x2 = real(self, key, x, b, aux)
        if x.ndim == 2:
            x2 = torch.cat([x2[:, : x.shape[1] // 2], x[:, x.shape[1] // 2:]], dim=1)
        return key2, x2

    monkeypatch.setattr(MGMCSampler, "step", half)
    assert not _run(root, cell)["correct"]


@pytest.mark.parametrize("cell", GRID + MESH)
def test_sound_run_passes(root, cell):
    assert _run(root, cell)["correct"]
