"""The port's training substrate beside the LM loop, against JAX's on the
CPU: ``data/tokens.py::SyntheticTokens`` (batches bit-equal),
``distributed/elastic.py`` (``tests/test_substrate.py``'s cases, plans and
monitor actions equal), and ``train/grad_compression.py``'s
``compress_leaf`` error feedback (bit-equal).  ``compressed_psum`` across
two processes is in ``test_torch_grad_compression.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.tokens import SyntheticTokens as JTokens
from repro.distributed import elastic as jel
from repro.train import grad_compression as jgc
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.distributed import elastic as tel
from repro_torch.train import grad_compression as tgc


@pytest.mark.parametrize("vocab,seq,batch,seed,shard,n_shards", [
    (97, 16, 4, 3, 0, 1), (8192, 64, 2, 0, 1, 4), (49408, 8, 3, 11, 3, 4),
])
def test_synthetic_tokens_bit_equal_to_jax(vocab, seq, batch, seed, shard, n_shards):
    kw = dict(vocab=vocab, seq_len=seq, batch=batch, seed=seed, shard=shard, n_shards=n_shards)
    a, b = SyntheticTokens(**kw), JTokens(**kw)
    for _ in range(5):
        x, y = next(a), next(b)
        for k in ("tokens", "targets"):
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])
    assert a.state() == b.state() == {"step": 5, "shard": shard, "seed": seed}


def test_synthetic_tokens_restore_and_shards_as_jax():
    a = SyntheticTokens(vocab=97, seq_len=16, batch=4, seed=3)
    b1, b2 = next(a), next(a)
    state = a.state()
    b3 = next(a)
    c = SyntheticTokens(vocab=97, seq_len=16, batch=4, seed=3)
    c.restore(state)
    np.testing.assert_array_equal(next(c)["tokens"], b3["tokens"])
    assert not np.array_equal(b1["tokens"], b2["tokens"])
    j = JTokens(vocab=97, seq_len=16, batch=4, seed=3)
    j.restore(state)
    np.testing.assert_array_equal(next(j)["tokens"], b3["tokens"])
    s0 = next(SyntheticTokens(vocab=97, seq_len=16, batch=4, seed=3, shard=0, n_shards=2))
    s1 = next(SyntheticTokens(vocab=97, seq_len=16, batch=4, seed=3, shard=1, n_shards=2))
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    np.testing.assert_array_equal(s0["targets"][:, :-1], s0["tokens"][:, 1:])


@pytest.mark.parametrize("old,new,batch", [(512, 256, 256), (256, 512, 256), (256, 48, 100),
                                           (512, 768, 256), (256, 32, 7)])
def test_elastic_plan_equals_jax(old, new, batch):
    got = tel.plan_elastic_restart(old_chips=old, new_chips=new, global_batch=batch)
    want = jel.plan_elastic_restart(old_chips=old, new_chips=new, global_batch=batch)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.keeps_global_batch == want.keeps_global_batch


def test_elastic_plan_rejects_tp_break_as_jax():
    for mod in (tel, jel):
        with pytest.raises(ValueError, match="TP=16"):
            mod.plan_elastic_restart(old_chips=256, new_chips=250, global_batch=256)


@pytest.mark.parametrize("pattern", ["every7", "burst", "noisy"])
def test_straggler_monitor_equals_jax(pattern):
    rng = np.random.default_rng(4)
    if pattern == "every7":
        times = [1.0 if s % 7 else 5.0 for s in range(40)]
    elif pattern == "burst":
        times = [1.0] * 12 + [3.0] * 10 + [1.0] * 20
    else:
        times = list(rng.lognormal(0.0, 0.4, 80))
    kw = dict(tolerance=1.5, window=32, min_samples=4 if pattern == "every7" else 8)
    t, j = tel.StragglerMonitor(**kw), jel.StragglerMonitor(**kw)
    got = [t.observe(s, dt) for s, dt in enumerate(times)]
    assert got == [j.observe(s, dt) for s, dt in enumerate(times)]
    assert t.flagged_steps == j.flagged_steps
    if pattern == "every7":
        assert "flag" in got and "replace" in got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_leaf_error_feedback_equals_jax(dtype):
    """Three rounds of compress -> carry the residual: the int8 payload and
    the residual bit-equal to JAX's, the residual within half a step, and
    decompress equal too.  Values on half steps test round-half-to-even."""
    rng = np.random.default_rng(9)
    g = rng.standard_normal((4, 33)).astype(np.float32)
    g[0, :4] = [0.5, 1.5, -2.5, 126.5]
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    t_err, j_err = tgc.init_error_state([tg])[0], jnp.zeros(g.shape, jnp.float32)
    assert t_err.dtype == torch.float32
    for r in range(3):
        # round 0 at scale 1 puts values on half steps; later rounds take
        # compressed_psum's scale from |g + err| (one process)
        gf = tg.float() + t_err
        scale = np.float32(1.0) if r == 0 else np.float32(float(gf.abs().max()) / 127.0)
        tq, t_err = tgc.compress_leaf(tg, t_err, torch.tensor(scale))
        jq, j_err = jgc.compress_leaf(jg, j_err, jnp.asarray(scale))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(t_err.numpy(), np.asarray(j_err))
        if r == 0:
            assert tq[0, :4].tolist() == [0, 2, -2, 126]  # half to even
        else:
            assert float(t_err.abs().max()) <= scale / 2 * (1 + 1e-6)
        td = tgc.decompress_leaf(tq.to(torch.int32) * 3, torch.tensor(scale), 3.0)
        jd = jgc.decompress_leaf(jq.astype(jnp.int32) * 3, jnp.asarray(scale), jnp.float32(3.0))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
