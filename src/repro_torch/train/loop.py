"""Production training loop: checkpoint/restart, stragglers, metrics.

Port of ``repro/train/loop.py``.  Drives any registered architecture end
to end on one device (``cuda`` unless the caller asks for the CPU), or
over a named mesh (``launch/mesh.py``):

    loop = TrainLoop(arch_name, seq_len, global_batch, None, run_dir, ...)
    loop.run(total_steps)

Fault tolerance (JAX's model, the same events in ``metrics.jsonl``):

* an async checkpoint of ``(params, opt_state)`` and the data stream's
  state every ``ckpt_every`` steps and at the end (atomic commit; survives
  kill)
* on startup, auto-resume from LATEST, including the data-stream position
* a failure injected (or raised) mid-run triggers restore-and-continue
  inside ``run``, at most three times
* per-step wall times (the ``float(loss)`` sync included) feed a
  :class:`StragglerMonitor`; its actions are logged

``mesh``: ``None`` or a one-shard mesh trains on ``device``.  A mesh of
several shards trains FSDP + TP over it (``launch/steps.py``), inside
``activation_rules(mesh)`` as JAX's loop does: the state is made on
``device`` and placed by the first step; checkpoints hold whole leaves, so
a run resumes on another mesh than the one that wrote them.  The loop
feeds token batches only, as JAX's does: Whisper (which trains on audio
frames) trains, on one device or a mesh, through
``launch/steps.py::build_train_step``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.distributed.elastic import StragglerMonitor
from repro_torch.distributed.sharding import activation_rules
from repro_torch.launch.steps import as_mesh, build_train_step
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import Arch, ShapeSpec, get_arch
from repro_torch.train import optimizer as opt_lib

__all__ = ["TrainLoop"]


@dataclasses.dataclass
class TrainLoop:
    arch_name: str
    seq_len: int
    global_batch: int
    mesh: object  # None, a named Mesh (or a 1-D DeviceMesh)
    run_dir: str
    reduced: bool = True
    lr: float = 3e-4
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    fail_at_step: int | None = None  # fault-injection hook (tests/examples)
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)
        self.arch: Arch = get_arch(self.arch_name)
        self.cfg = self.arch.reduced_config if self.reduced else self.arch.config
        self.shape = ShapeSpec("train_loop", self.seq_len, self.global_batch, "train")
        self.run_path = pathlib.Path(self.run_dir)
        self.run_path.mkdir(parents=True, exist_ok=True)
        self.ckpt = Checkpointer(self.run_path / "ckpt")
        self.monitor = StragglerMonitor()
        self._metrics_path = self.run_path / "metrics.jsonl"
        # refuses, before any work, a family the mesh cannot run
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        optimizer = opt_lib.adamw(opt_lib.linear_warmup_cosine(self.lr, 20, 10_000))
        bundle = build_train_step(self.arch, self.shape, self.mesh, self.cfg, optimizer=optimizer)
        return optimizer, bundle.jitted

    def _init_state(self, optimizer):
        gen = torch.Generator(device=self._device).manual_seed(self.seed)
        params = self.arch.init_params(gen, self.cfg)
        opt_state = optimizer.init([t for _, t in tree_leaves(params)])
        return params, opt_state

    def _data(self) -> SyntheticTokens:
        return SyntheticTokens(
            vocab=self.cfg.vocab, seq_len=self.seq_len, batch=self.global_batch, seed=self.seed
        )

    def _log(self, record: dict):
        with self._metrics_path.open("a") as f:
            f.write(json.dumps(record) + "\n")

    # ------------------------------------------------------------------
    def run(self, total_steps: int) -> dict:
        with activation_rules(as_mesh(self.mesh)):
            return self._run(total_steps)

    def _run(self, total_steps: int) -> dict:
        optimizer, train_step = self._build()
        data = self._data()
        params, opt_state = self._init_state(optimizer)
        start = 0
        if latest_step(self.run_path / "ckpt") is not None:
            (params, opt_state), user = self.ckpt.restore((params, opt_state))
            data.restore(user["data"])
            start = user["step"]
            self._log({"event": "resume", "step": start})

        step = start
        failures = 0
        losses = []
        while step < total_steps:
            try:
                batch = next(data)
                if self.fail_at_step is not None and step == self.fail_at_step:
                    self.fail_at_step = None  # fail exactly once
                    raise RuntimeError("injected node failure")
                t0 = time.time()
                batch = {k: torch.from_numpy(v).to(self._device) for k, v in batch.items()}
                params, opt_state, metrics = train_step(params, opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.time() - t0
                losses.append(loss)
                action = self.monitor.observe(step, dt)
                if action:
                    self._log({"event": "straggler", "step": step, "action": action, "dt": dt})
                if step % self.log_every == 0:
                    self._log({"event": "step", "step": step, "loss": loss, "dt": round(dt, 4)})
                step += 1
                if step % self.ckpt_every == 0 or step == total_steps:
                    self.ckpt.save(step, (params, opt_state), {"step": step, "data": data.state()})
            except RuntimeError as e:
                # node failure path: restore the last committed state and
                # continue -- the preemption story at fleet scale
                failures += 1
                self._log({"event": "failure", "step": step, "error": str(e)})
                if failures > 3:
                    raise
                self.ckpt.wait()
                if latest_step(self.run_path / "ckpt") is None:
                    params, opt_state = self._init_state(optimizer)
                    step = 0
                    data = self._data()
                else:
                    (params, opt_state), user = self.ckpt.restore((params, opt_state))
                    data.restore(user["data"])
                    step = user["step"]
                self._log({"event": "restored", "step": step})
        self.ckpt.wait()
        return {
            "final_step": step,
            "final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "failures": failures,
            "metrics_path": str(self._metrics_path),
        }
