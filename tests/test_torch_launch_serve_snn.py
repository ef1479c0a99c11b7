"""The port's SNN serving launcher end to end on the CPU, at a small size.

``repro_torch.launch.serve_snn.main([..., "--device", "cpu"])`` in its
replay and ``--streaming`` modes, and recovering work a crashed run left in
its journal: every mode exits normally, prints its report, and leaves the
journal with nothing outstanding.
"""

import re

import numpy as np

from repro_torch.launch import serve_snn
from repro_torch.serve.journal import Journal, read_records, recover

SMALL = ["--T", "6", "--hidden", "16", "--max-batch", "2", "--device", "cpu"]


def test_replay_mode_serves_and_journals(tmp_path, capsys):
    serve_snn.main(["--requests", "5", "--journal", str(tmp_path / "wal"), *SMALL])
    out = capsys.readouterr().out
    assert "served 5 requests on serve-256-16-10" in out and "device=cpu" in out
    kinds = [r.kind for r in read_records(tmp_path / "wal")]
    assert kinds.count("submit") == 5 and kinds.count("done") == 5
    assert recover(tmp_path / "wal").requests == []


def test_streaming_mode_with_eviction_churn(tmp_path, capsys):
    serve_snn.main([
        "--streaming", "3", "--stream-steps", "24", "--stream-chunk", "4",
        "--stream-window", "8", "--stream-stride", "4", "--stream-idle", "1",
        "--stream-ckpt", str(tmp_path / "ck"), "--no-journal", *SMALL,
    ])
    out = capsys.readouterr().out
    assert "streamed 3 sessions x 24 steps" in out
    assert "stream0: t_total=24" in out and "readouts=6" in out
    evictions, restores = map(int, re.search(r"evictions=(\d+) restores=(\d+)", out).groups())
    assert evictions > 0 and restores > 0


def test_recovers_outstanding_work_from_a_crashed_run(tmp_path, capsys):
    rng = np.random.default_rng(3)
    with Journal(tmp_path / "wal") as j:  # a run that died with 3 admitted, 1 done
        for uid in range(3):
            raster = (rng.random((6, 256)) < 0.2).astype(np.uint8)
            j.append("submit", arrays={"raster": raster}, uid=uid, priority=1,
                     tenant="default", deadline_s=None)
        j.append("done", uid=1, status="completed")
    serve_snn.main(["--requests", "0", "--journal", str(tmp_path / "wal"), *SMALL])
    out = capsys.readouterr().out
    assert "'requests_resubmitted': 2" in out
    assert "served 2 requests" in out
    assert recover(tmp_path / "wal").requests == []
