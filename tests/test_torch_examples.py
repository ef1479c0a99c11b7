"""The port's examples (``examples_torch/``) and chaos smoke
(``scripts/chaos_smoke_torch.py``) end to end on the CPU, held to the JAX
package.

Each runs through its ``main`` with ``--device cpu`` at a small size; what
it produced is then carried to the JAX package through numpy and recomputed
there: the quickstart's deployed accuracy, event statistics and modeled
design point; the served counts of ``serve_snn``'s requests; the resources
in ``flexplorer_dse``'s ``design.json`` and its weight tables;
``serve_quantized``'s structural bytes and the card's HBM rate under them;
``lm_train_100m``'s model size, failure recovery and resume; and the chaos
smoke's verdict on JAX-made weights, with and without a planted fault.
"""

import ast
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hw_model as jhw
from repro.core import network as jnet
from repro.data import snn_datasets as jds
from repro.distributed.structural import structural_bytes as j_structural_bytes
from repro.models.registry import SHAPES as J_SHAPES
from repro.models.registry import get_arch as j_get_arch
from repro.serve import snn_engine as jeng
from repro.snn import train as jtrain
from _serial_oracle import jax_net, jax_qparams
from repro_torch.core.network import int_params_from_numpy, run_int

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples_torch import (  # noqa: E402
    flexplorer_dse,
    lm_train_100m,
    load_chaos_smoke,
    quickstart,
    serve_quantized,
    serve_snn,
)


def test_quickstart_deploys_what_jax_scores(capsys):
    out = quickstart.main(["--device", "cpu", "--n", "256"])
    printed = capsys.readouterr().out
    assert f"bit-exact quantized accuracy: {out['accuracy']:.4f}" in printed
    assert "modeled at 60 MHz (not a time of this device)" in printed
    assert "measured on the CPU" in printed
    jn = jax_net(out["net"])
    _, jtest = jds.mnist_like(n=256, T=25, seed=0).split()
    assert jtest.spikes.tobytes() == out["test"].spikes.tobytes()
    acc, stats = jtrain.eval_int(jn, jax_qparams(out["qparams"]), jtest, return_stats=True)
    assert acc == out["accuracy"]
    np.testing.assert_array_equal(out["stats"]["input_events_per_step"],
                                  np.asarray(stats["input_events_per_step"]))
    for got, want in zip(out["stats"]["layer_events_per_step"], stats["layer_events_per_step"]):
        np.testing.assert_array_equal(got, np.asarray(want))
    traffic = jhw.EventTraffic.from_stats(stats)
    assert dataclasses.astuple(out["design"]) == dataclasses.astuple(jhw.design_point(jn, traffic))
    assert dataclasses.astuple(out["resources"]) == dataclasses.astuple(jhw.network_resources(jn))


def test_serve_snn_counts_equal_jax_engine(capsys):
    out = serve_snn.main(["--device", "cpu"])
    assert "bit-exact vs serial run_int: 11/11 requests" in capsys.readouterr().out
    assert out["mismatches"] == [] and len(out["done"]) == 11
    jn = jax_net(serve_snn.NET)
    engine = jeng.SNNServeEngine(jn, jax_qparams(out["qparams"]), max_batch=4, backend="event")
    reqs = [jeng.SNNRequest(uid=i, raster=r) for i, r in enumerate(serve_snn.rasters())]
    want = {r.uid: np.asarray(r.spike_counts) for r in engine.run(reqs)}
    got = {r.uid: r.spike_counts for r in out["done"]}
    assert sorted(got) == sorted(want) == list(range(11))
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


def test_serve_snn_exits_non_zero_on_a_mismatch(monkeypatch):
    real = serve_snn.serial_mismatches
    monkeypatch.setattr(serve_snn, "serial_mismatches",
                        lambda q, done, dev: real(q, done, dev) + [done[0].uid])
    with pytest.raises(SystemExit) as exc:
        serve_snn.main(["--device", "cpu"])
    assert exc.value.code == 1


def test_flexplorer_package_matches_jax(tmp_path):
    out_dir = tmp_path / "pkg"
    found = flexplorer_dse.main(["--device", "cpu", "--n", "160", "--out", str(out_dir)])
    assert found["out"] == out_dir
    design = json.loads((out_dir / "design.json").read_text())
    jn = jax_net(found["deploy_net"])
    res = jhw.network_resources(jn)
    assert list(design) == ["layers", "resources"]
    assert design["resources"] == {"lut": float(res.lut), "ff": float(res.ff),
                                   "bram": float(res.bram), "logic_cells": float(res.logic_cells)}
    assert design["layers"] == [
        {"n_in": lc.n_in, "n_out": lc.n_out, "neuron": lc.neuron.value,
         "topology": lc.topology.value, "w_bits": lc.w_bits, "w_rec_bits": lc.w_rec_bits,
         "leak_bits": lc.leak_bits, "decay_register": lc.beta_code().decay_rate_register}
        for lc in jn.layers
    ]
    weights = np.load(out_dir / "weights_q.npz")
    qparams = found["deploy_qparams"]
    assert sorted(weights.files) == [f"layer{i}_wff" for i in range(len(qparams))]
    for i, q in enumerate(qparams):
        assert weights[f"layer{i}_wff"].dtype == np.int32
        np.testing.assert_array_equal(weights[f"layer{i}_wff"], q.w_ff.numpy())
    sample = np.load(out_dir / "encoded_sample.npy")
    assert sample.dtype == np.uint8 and sample.tobytes() == found["test"].spikes[:16].tobytes()
    # the reloaded tables (with the run's recurrent registers and thresholds,
    # which the package does not carry) give JAX's records on its sample
    arrays = [(weights[f"layer{i}_wff"], q.w_rec.numpy(), q.theta_q.numpy())
              for i, q in enumerate(qparams)]
    reloaded = int_params_from_numpy(found["deploy_net"], arrays, device="cpu")
    x = sample.transpose(1, 0, 2).astype(np.int32)
    got = run_int(found["deploy_net"], reloaded, torch.from_numpy(x))
    want = jnet.run_int(jn, jax_qparams(reloaded), jnp.asarray(x))
    np.testing.assert_array_equal(got.spike_counts.numpy(), np.asarray(want.spike_counts))
    for a, b in zip(got.layer_spikes, want.layer_spikes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_serve_quantized_bytes_equal_jax_at_the_cards_rate(capsys):
    out = serve_quantized.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "NVIDIA H100 SXM's HBM roofline (3.35 TB/s" in printed
    for label, (tokens, wall) in out["results"].items():
        assert sorted(tokens) == [0, 1, 2] and all(len(t) == 8 for t in tokens.values())
        assert wall > 0
    arch = j_get_arch("gemma2-27b")
    for label, bits in (("bf16/f32", None), ("int8", 8), ("int4", 4)):
        want = j_structural_bytes(arch, J_SHAPES["decode_32k"], quant_bits=bits)["total"]
        got = out["traffic"][label]
        assert got["bytes"] == want
        assert got["us_per_step"] == want / 3.35e12 * 1e6


def test_lm_train_100m_recovers_and_resumes(tmp_path):
    cfg = lm_train_100m.config_100m()
    jcfg = dataclasses.replace(
        j_get_arch("stablelm-1.6b").reduced_config,
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=8, d_head=64, d_ff=1408, vocab=8192,
    )
    want = sum(x.size for x in jax.tree.leaves(
        j_get_arch("stablelm-1.6b").abstract_params(jcfg)))
    assert lm_train_100m.n_params(cfg) == want
    tiny = dataclasses.replace(cfg, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32,
                               d_ff=128, vocab=256)
    run_dir = str(tmp_path / "run")
    out = lm_train_100m.train(tiny, steps=8, run_dir=run_dir, device="cpu", seq_len=32,
                              global_batch=4)
    assert out["failures"] == 1 and out["final_step"] == 8
    assert np.isfinite(out["final_loss"]) and out["final_loss"] < out["first_loss"]
    more = lm_train_100m.train(tiny, steps=10, run_dir=run_dir, device="cpu", seq_len=32,
                               global_batch=4)
    assert more["final_step"] == 10 and more["failures"] == 0
    events = [json.loads(line) for line in open(out["metrics_path"])]
    kinds = [(e["event"], e["step"]) for e in events if e["event"] != "straggler"]
    assert ("failure", 4) in kinds and ("restored", 0) in kinds
    assert ("resume", 8) in kinds


def _jax_made_chaos_qparams(mod):
    jn = jax_net(mod.NET)
    jq, _ = jnet.quantize_params(jn, jnet.init_float_params(jax.random.PRNGKey(0), jn))
    return int_params_from_numpy(mod.NET, [tuple(np.asarray(a) for a in p) for p in jq], "cpu")


def test_chaos_smoke_passes_on_jax_made_weights(capsys):
    """Exit 0 on JAX-made weights, every tick of the supervised engine on the
    f32_exact route: JAX's engine on the same net and weights holds the same
    route deciders (no event budget, the same f32 input bound), so for these
    binary rasters it takes that route too."""
    mod = load_chaos_smoke()
    qparams = _jax_made_chaos_qparams(mod)
    assert mod.smoke(qparams, device="cpu") == 0
    printed = capsys.readouterr().out
    assert "chaos smoke OK: 12 requests bit-exact through 3 injected faults" in printed
    routes = printed.split("ticks by route ")[1].split("}")[0] + "}"
    assert list(ast.literal_eval(routes)) == ["tick:f32_exact"]
    port = mod.SNNServeEngine(mod.NET, qparams, max_batch=4, tick_stride=2, device="cpu")
    jax_engine = jeng.SNNServeEngine(jax_net(mod.NET), jax_qparams(qparams), max_batch=4,
                                     tick_stride=2)
    for eng in (port, jax_engine):
        assert eng._event_budget is None and eng._f32_input_max >= 1
    assert port._f32_input_max == jax_engine._f32_input_max
    assert mod.main(["--device", "cpu"]) == 0


def test_chaos_smoke_fails_a_planted_fault(monkeypatch, capsys):
    """A bit flipped in the serial oracle's counts must turn the verdict."""
    mod = load_chaos_smoke()
    real = mod.run_int

    def flipped(net, qparams, x):
        rec = real(net, qparams, x)
        rec.spike_counts[0, 0] ^= 1
        return rec

    monkeypatch.setattr(mod, "run_int", flipped)
    assert mod.smoke(_jax_made_chaos_qparams(mod), device="cpu") == 1
    assert "not bit-exact vs run_int" in capsys.readouterr().err
