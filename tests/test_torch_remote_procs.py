"""PyTorch port: the process-per-replica fleet (``streaming/remote.py``)
with real worker processes on the CPU, one soak round a test
(``tools/chaos_soak.run_remote_soak``) on the soak's tiny LM (d 32, 2
layers): A, a worker SIGKILLed mid-stream, respawned and re-adopted under
its id; C, a SIGSTOP partition whose zombie's late results are fenced.
(Rounds B and D, the role-split wire handoff and the router restart, run
on the card in ``chip_smoke.py``'s phase 4f, and by ``python -m
deeplearning4j_tpu_torch.tools.chaos_soak --remote --device cpu``.)
Every round is held token-identical to the port's in-process engine
built as the workers build theirs, with nothing lost or duplicated, the
workers' weights digest equal to the parent's and no worker left alive.
Each round has its own deadlines (every wait in the soak polls for its
state), and every child this test started is killed in a ``finally``."""

import os
import signal

import pytest

from deeplearning4j_tpu_torch.tools import chaos_soak


@pytest.mark.parametrize("rnd", ["a", "c"])
def test_remote_round_on_cpu(rnd, tmp_path):
    before = chaos_soak.child_pids()
    try:
        s = chaos_soak.run_remote_soak(seed=0, rounds=rnd, device="cpu",
                                       round_wait_s=90.0,
                                       hello_deadline=90.0,
                                       workdir=str(tmp_path))
    finally:
        for pid in chaos_soak.child_pids() - before:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
    row = s[f"round_{rnd}"]
    assert s["ok"], {"row": row, "leftover": s.get("leftover_pids"),
                     "logs": s.get("worker_logs")}
    assert row["mismatches"] == 0 and row["lost"] == 0
    assert all(w["device"] == "cpu" for w in row["workers"].values())
    assert len({w["params_digest"] for w in row["workers"].values()}) == 1
    assert s["leftover_pids"] == []
    if rnd == "a":
        assert row["respawn_epoch"] >= 2
        assert 0 < row["results_at_kill"] < s["requests"]
    if rnd == "c":
        assert row["migrations"] >= 1
        assert row["zombie_fenced"]["after_heal"] >= 1 or \
            not row["held_at_pause"]
