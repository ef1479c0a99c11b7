"""The port's production training loop (``train/loop.py::TrainLoop``) and
its launcher (``launch/train.py``) on the CPU.

``tests/test_system.py::test_train_loop_survives_injected_failure`` on the
port; a run killed between checkpoints and resumed equals an uninterrupted
run in every loss and final parameter (bit for bit: the CPU is
deterministic, and the checkpoint carries parameters, AdamW state and the
data stream exactly); the ``metrics.jsonl`` events equal JAX's loop's for
the same schedule (the straggler events, which read wall times, apart);
the refusal of a family not sharded yet and the launcher.
"""

import json
from unittest import mock

import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.train.loop import TrainLoop as JTrainLoop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.shard import make_mesh
from repro_torch.launch import train as tlaunch
from repro_torch.train import loop as tloop
from repro_torch.train.loop import TrainLoop


def _loop(run_dir, **kw):
    args = dict(arch_name="stablelm-1.6b", seq_len=32, global_batch=4, mesh=None,
                run_dir=str(run_dir), ckpt_every=5, log_every=5, device="cpu")
    return TrainLoop(**{**args, **kw})


def _events(path, keep=("step", "failure", "restored", "resume")):
    out = []
    for line in open(path):
        r = json.loads(line)
        if r["event"] in keep:
            out.append((r["event"], r["step"], r.get("error")))
    return out


def test_train_loop_survives_injected_failure(tmp_path):
    out = _loop(tmp_path, fail_at_step=12).run(total_steps=20)
    assert out["failures"] == 1
    assert out["final_step"] == 20
    assert out["final_loss"] < out["first_loss"]
    events = [line for line in open(out["metrics_path"])]
    assert any('"failure"' in line for line in events)
    assert any('"restored"' in line for line in events)


def test_events_equal_jax_for_the_same_schedule(tmp_path):
    """Failure at 12 with checkpoints every 5, then a second ``run`` on the
    same directory that resumes from LATEST: the same events at the same
    steps in both packages."""
    got, want = [], []
    for loop_cls, mesh, out in [(TrainLoop, None, got), (JTrainLoop, j_host_mesh(), want)]:
        run_dir = tmp_path / loop_cls.__module__
        kw = dict(arch_name="stablelm-1.6b", seq_len=32, global_batch=4, mesh=mesh,
                  run_dir=str(run_dir), ckpt_every=5, log_every=5, fail_at_step=12)
        if loop_cls is TrainLoop:
            kw["device"] = "cpu"
        first = loop_cls(**kw).run(total_steps=16)
        second = loop_cls(**kw).run(total_steps=22)  # resumes at 16, past the failure step
        out.extend(_events(first["metrics_path"]))
        out.append(("final", first["final_step"], first["failures"]))
        out.append(("final", second["final_step"], second["failures"]))
    assert got == want
    assert ("resume", 16, None) in got and ("restored", 10, None) in got


class Killed(BaseException):
    """A kill between checkpoints: not a RuntimeError, so the loop's
    restore-and-continue path does not catch it."""


def test_kill_and_resume_equals_an_uninterrupted_run(tmp_path):
    whole = _loop(tmp_path / "whole", log_every=1)
    out_whole = whole.run(total_steps=14)
    killed = _loop(tmp_path / "killed", log_every=1)
    real = tloop.build_train_step
    calls = {"n": 0}

    def killing(*a, **kw):
        bundle = real(*a, **kw)
        step = bundle.jitted

        def fn(*args):
            calls["n"] += 1
            if calls["n"] == 9:  # during step 8: checkpoints at 5 only
                raise Killed
            return step(*args)

        bundle.jitted = fn
        return bundle

    with mock.patch.object(tloop, "build_train_step", killing), pytest.raises(Killed):
        killed.run(total_steps=14)
    killed.ckpt.wait()
    out_resumed = _loop(tmp_path / "killed", log_every=1).run(total_steps=14)
    assert out_resumed["final_step"] == out_whole["final_step"] == 14
    losses = lambda p: {s: loss for e, s, loss in _step_losses(p)}
    whole_losses, resumed_losses = losses(out_whole["metrics_path"]), losses(out_resumed["metrics_path"])
    assert _events(out_resumed["metrics_path"])[8] == ("resume", 5, None)
    for s in range(14):  # steps 5..7 ran twice on the killed run: same losses each time
        assert resumed_losses[s] == whole_losses[s], s
    a = Checkpointer(tmp_path / "whole" / "ckpt").restore(_template(whole))
    b = Checkpointer(tmp_path / "killed" / "ckpt").restore(_template(whole))
    assert a[1] == b[1]
    for x, y in zip(_flat(a[0]), _flat(b[0])):
        np.testing.assert_array_equal(x, y)


def _step_losses(path):
    for line in open(path):
        r = json.loads(line)
        if r["event"] == "step":
            yield r["event"], r["step"], r["loss"]


def _template(loop):
    optimizer, _ = loop._build()
    return loop._init_state(optimizer)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


def test_more_than_three_failures_raise(tmp_path):
    loop = _loop(tmp_path)
    with mock.patch.object(tloop, "build_train_step") as build:
        build.return_value.jitted.side_effect = RuntimeError("node lost")
        with pytest.raises(RuntimeError, match="node lost"):
            loop.run(total_steps=3)
    assert [e for e, *_ in _events(loop._metrics_path)] == ["failure", "restored"] * 3 + ["failure"]


def test_multi_device_mesh_is_refused(tmp_path):
    """A mesh of several shards trains every family sharded: the loop builds
    its step for Whisper too (which it feeds token batches only, as JAX's
    does, so Whisper trains through ``build_train_step``)."""
    two = make_mesh(2, devices=["cpu", "cpu"])
    assert _loop(tmp_path, arch_name="whisper-medium", mesh=two).mesh is two
    _loop(tmp_path, arch_name="whisper-medium", mesh=make_mesh(1, devices=["cpu"]))
    _loop(tmp_path, mesh=make_mesh(2, devices=["cpu", "cpu"]))  # dense: data-parallel over two
    _loop(tmp_path, arch_name="granite-moe-1b-a400m", mesh=make_mesh(2, devices=["cpu", "cpu"]))


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoop("stablelm-1.6b", 32, 4, None, str(tmp_path))


def test_launch_train_main_on_the_cpu(tmp_path, capsys):
    run_dir = tmp_path / "run"
    argv = ["--arch", "granite-moe-1b-a400m", "--steps", "6", "--seq-len", "16", "--batch", "2",
            "--run-dir", str(run_dir), "--ckpt-every", "3", "--fail-at", "4", "--device", "cpu"]
    out = tlaunch.main(argv)
    assert out["final_step"] == 6 and out["failures"] == 1
    assert json.loads(capsys.readouterr().out) == out
    again = tlaunch.main(argv[:3] + ["8"] + argv[4:])  # resumes at 6
    assert again["final_step"] == 8 and again["failures"] == 0  # --fail-at 4 lies behind it
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        tlaunch.main(argv + ["--production-mesh", "single"])
