"""The port's ``compressed_psum`` over a two-process gloo group against
JAX's ``compressed_psum`` under ``jax.vmap(..., axis_name="pod")`` with two
members, for three rounds of error feedback: every process's mean and
error carry bit-equal to JAX's member of the same index.  The two processes
meet through a ``file://`` rendezvous under ``tmp_path`` and run under a
wall limit of their own (``tests/test_torch_distributed.py``'s pattern).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.train import grad_compression as jgc

ROOT = Path(__file__).resolve().parents[1]
WALL_S = 120  # the 2-process test's own limit
ROUNDS = 3
DTYPES = ("float32", "bfloat16", "float32")


def grads(rank: int, r: int) -> list[np.ndarray]:
    """Round ``r``'s gradients of process ``rank`` (f32 arrays; leaf 1 is
    carried in bf16 on both sides)."""
    rng = np.random.default_rng(100 * r + rank)
    return [
        (rng.standard_normal((4, 33)) * (1 + rank)).astype(np.float32),
        rng.standard_normal(16).astype(np.float32),
        (rng.standard_normal((3, 5, 7)) * 1e-3).astype(np.float32),
    ]


WORKER = """
import sys
sys.path[:0] = [sys.argv[4], sys.argv[5]]
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.distributed import compat
from repro_torch.train.grad_compression import compressed_psum, init_error_state
from test_torch_grad_compression import DTYPES, ROUNDS, grads
rank = int(sys.argv[1])
assert compat.maybe_init_distributed("file://" + sys.argv[2], 2, rank)
out, err = {}, None
for r in range(ROUNDS):
    g = [torch.from_numpy(a).to(getattr(torch, d)) for a, d in zip(grads(rank, r), DTYPES)]
    err = init_error_state(g) if err is None else err
    mean, err = compressed_psum(g, err)
    for i, (m, e) in enumerate(zip(mean, err)):
        out[f"mean{r}_{i}"] = m.float().numpy()
        out[f"err{r}_{i}"] = e.numpy()
np.savez(sys.argv[3], **out)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture
def no_coordinator(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)


def _jax_rounds():
    f = jax.vmap(lambda g, e: jgc.compressed_psum(g, e, "pod"), axis_name="pod")
    want, err = {}, None
    for r in range(ROUNDS):
        g = [
            jnp.stack([jnp.asarray(grads(rank, r)[i]) for rank in (0, 1)]).astype(getattr(jnp, d))
            for i, d in enumerate(DTYPES)
        ]
        err = jgc.init_error_state(g) if err is None else err
        mean, err = f(g, err)
        for i, (m, e) in enumerate(zip(mean, err)):
            want[f"mean{r}_{i}"] = np.asarray(m.astype(jnp.float32))
            want[f"err{r}_{i}"] = np.asarray(e)
    return want


def test_two_process_compressed_psum_equals_jax_vmap(no_coordinator, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    rdv = tmp_path / "rendezvous"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(rdv), str(tmp_path / f"r{rank}.npz"),
             str(ROOT / "src"), str(ROOT / "tests")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in (0, 1)
    ]
    try:
        errs = [p.communicate(timeout=WALL_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    want = _jax_rounds()
    for rank in (0, 1):
        got = np.load(tmp_path / f"r{rank}.npz")
        assert sorted(got.files) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k][rank], err_msg=f"rank {rank} {k}")
    # the mean is shared: both processes hold the same values
    a, b = np.load(tmp_path / "r0.npz"), np.load(tmp_path / "r1.npz")
    for r in range(ROUNDS):
        np.testing.assert_array_equal(a[f"mean{r}_0"], b[f"mean{r}_0"])
