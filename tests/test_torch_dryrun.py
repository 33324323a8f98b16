"""The port's multi-device dry run (``parmgmc_tpu_torch.parallel.dryrun``,
the port of ``dryrun_multichip`` in ``__graft_entry__.py``) on 8 slots on
the host: every block runs, passes the JAX dry run's tolerance and prints
its line."""

import pytest
import torch

from parmgmc_tpu_torch.parallel.dryrun import dryrun_multichip

# the entry points default to the card; these tests run on the host
DEV = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_dryrun_multichip_on_8_host_slots(capsys):
    dryrun_multichip(8, devices=[DEV] * 8)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 6 and all(" OK: 8 " in ln or "OK: mesh" in ln for ln in lines), lines
    assert "bit for bit" in lines[0]


def test_dryrun_needs_distinct_cards_unless_told():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="distinct CUDA devices"):
        dryrun_multichip(have + 2)
