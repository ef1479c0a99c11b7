"""The port's ``distributed/hlo_analysis.py`` against JAX's, on the CPU.

``parse_collectives`` of both packages on the same HLO text gives the same
``summary()``: JAX's own test lines (``tests/test_distribution.py``),
``-start`` / ``-done`` pairs, tuple results, ``reduce-scatter`` and
``ragged-all-to-all``, iota and ``{{...}}`` replica groups, ``pred`` and
``s4`` shapes, a line with no group (``g`` = 2), and the real HLO of the
reduced stablelm train step that JAX compiles on four forced host devices
(in a subprocess, since the device count is fixed when JAX starts).
``roofline_terms`` gives JAX's values given JAX's v5e constants; the
port's ``HW`` holds the H100 SXM's.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from repro.distributed import hlo_analysis as jh
from repro_torch.distributed import hlo_analysis as th

JAX_TEST_HLO = """
  %ag = bf16[32,1024]{1,0} all-gather(bf16[2,1024]{1,0} %p), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[128]{0} all-reduce(f32[128]{0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %cp = f32[64]{0} collective-permute(f32[64]{0} %y), source_target_pairs={{0,1}}
  %done = f32[8] all-reduce-done(f32[8] %h)
"""

CASES = {
    "jax_test_lines": JAX_TEST_HLO,
    "start_done_pairs": """
  %ags = (f32[4,8]{1,0}, f32[16,8]{1,0}) all-gather-start(f32[4,8]{1,0} %a), replica_groups={{0,1,2,3}}, dimensions={0}
  %agd = f32[16,8]{1,0} all-gather-done((f32[4,8]{1,0}, f32[16,8]{1,0}) %ags)
  %ars = f32[1024]{0} all-reduce-start(f32[1024]{0} %b), replica_groups=[2,4]<=[8], to_apply=%add
  %ard = f32[1024]{0} all-reduce-done(f32[1024]{0} %ars)
  %cps = (bf16[64]{0}, bf16[64]{0}) collective-permute-start(bf16[64]{0} %c), source_target_pairs={{0,1},{1,0}}
  %cpd = bf16[64]{0} collective-permute-done((bf16[64]{0}, bf16[64]{0}) %cps)
""",
    "tuple_all_reduce": """
  %t = (f32[], f32[64,128]{1,0}, bf16[2,64,128]{2,1,0}) all-reduce(f32[] %a, f32[64,128]{1,0} %b, bf16[2,64,128]{2,1,0} %c), replica_groups=[2,2]<=[4], to_apply=%add
""",
    "reduce_scatter_and_ragged": """
  %rs = f32[8,256]{1,0} reduce-scatter(f32[64,256]{1,0} %g), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}, to_apply=%add
  %ra = bf16[128,64]{1,0} ragged-all-to-all(bf16[128,64]{1,0} %x, bf16[128,64]{1,0} %o, s64[4]{0} %i, s64[4]{0} %s, s64[4]{0} %j, s64[4]{0} %k), replica_groups={{0,1,2,3}}
  %a2a = (f32[1,2,64,64]{3,2,1,0}, f32[1,2,64,64]{3,2,1,0}) all-to-all(f32[1,2,64,64]{3,2,1,0} %p, f32[1,2,64,64]{3,2,1,0} %q), replica_groups=[2,2]<=[2,2]T(1,0)
""",
    "iota_and_explicit_groups": """
  %g1 = f32[256]{0} all-gather(f32[16]{0} %p), replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
  %g2 = f32[256]{0} all-gather(f32[128]{0} %p), replica_groups={{0,1},{2,3}}, dimensions={0}
  %g3 = f32[512]{0} all-reduce(f32[512]{0} %p), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, to_apply=%add
""",
    "pred_and_s4": """
  %p = pred[1024]{0} all-gather(pred[256]{0} %m), replica_groups={{0,1,2,3}}, dimensions={0}
  %q = s4[64,128]{1,0} all-gather(s4[32,128]{1,0} %w), replica_groups={{0,1}}, dimensions={0}
  %r = u8[7]{0} all-reduce(u8[7]{0} %z), replica_groups={{0,1,2}}, to_apply=%or
""",
    "no_group": """
  %ar = f32[100]{0} all-reduce(f32[100]{0} %x), to_apply=%add
  %ag = bf16[8,8]{1,0} all-gather(bf16[4,8]{1,0} %y), dimensions={0}
  %one = f32[8]{0} all-reduce(f32[8]{0} %x), replica_groups={{0}}, to_apply=%add
""",
    "no_collectives": """
  %d = f32[128,128]{1,0} dot(f32[128,64]{1,0} %a, f32[64,128]{1,0} %b), lhs_contracting_dims={1}
  ROOT %t = (f32[128,128]{1,0}) tuple(%d)
""",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_collectives_matches_jax(name):
    text = CASES[name]
    assert th.parse_collectives(text).summary() == jh.parse_collectives(text).summary()


def test_parse_collectives_hand_counts():
    stats = th.parse_collectives(CASES["no_group"] + CASES["reduce_scatter_and_ragged"])
    # no group, and a group of one: g = 2
    assert stats.by_op["all-reduce"]["wire_bytes"] == pytest.approx(2 * 400 * 0.5 + 2 * 32 * 0.5)
    assert stats.by_op["all-gather"]["wire_bytes"] == pytest.approx(128 * 0.5)
    # reduce-scatter: the operand is the full tensor
    assert stats.by_op["reduce-scatter"]["wire_bytes"] == pytest.approx(64 * 256 * 4 * 7 / 8)
    assert stats.by_op["ragged-all-to-all"]["count"] == 1
    assert stats.n_ops == 6


@pytest.mark.parametrize(
    "op,full,g,want",
    [
        ("all-reduce", 1000, 4, 1500.0),
        ("all-gather", 1000, 4, 750.0),
        ("reduce-scatter", 1000, 8, 875.0),
        ("all-to-all", 1000, 2, 500.0),
        ("collective-permute", 1000, 16, 1000.0),
        ("all-gather", 1000, None, 500.0),
        ("all-reduce", 1000, 1, 1000.0),
    ],
)
def test_ring_wire_bytes(op, full, g, want):
    assert th.ring_wire_bytes(op, full, g) == want


_COMPILE = textwrap.dedent(
    """
    import dataclasses, os
    import repro.launch.dryrun as d  # sets a 512-device count; replaced before JAX starts
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.distributed.sharding import activation_rules
    from repro.models.common import unroll_scans
    from repro.models.registry import ShapeSpec, get_arch
    assert len(jax.devices()) == 4
    arch = get_arch("stablelm-1.6b")
    arch = dataclasses.replace(arch, config=arch.reduced_config)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    with mesh, activation_rules(mesh), unroll_scans():
        print(d.build_step(arch, ShapeSpec("train_4k", 64, 4, "train"), mesh).lower().compile().as_text())
    """
)


def test_parse_collectives_real_hlo():
    """The reduced stablelm train step, compiled by JAX over a (2, 2) mesh of
    four forced host devices with every scan unrolled."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([p for p in sys.path if p] + [env.get("PYTHONPATH", "")])
    res = subprocess.run([sys.executable, "-c", _COMPILE], capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    text = res.stdout
    got, want = th.parse_collectives(text).summary(), jh.parse_collectives(text).summary()
    assert got == want
    # the FSDP gathers, the backward's all-reduces, the attention's all-to-alls
    assert {"all-gather", "all-reduce", "all-to-all"} <= set(got["by_op"])
    assert got["n_ops"] > 20


def test_roofline_terms_match_jax_with_v5e_constants():
    v5e = th.HardwareConstants(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9, dcn_bw=3.1e9, hbm_bytes=16e9)
    assert dataclasses_fields(v5e) == dataclasses_fields(jh.HW)
    for args in [(197e12, 819e9 * 2, 0.0), (1e15, 1e9, 1e11), (0.0, 0.0, 0.0), (3.3e11, 4.4e9, 5.5e8)]:
        assert th.roofline_terms(*args, hw=v5e) == jh.roofline_terms(*args)


def dataclasses_fields(hw) -> dict:
    return {f: getattr(hw, f) for f in ("peak_flops", "hbm_bw", "ici_bw", "dcn_bw", "hbm_bytes")}


def test_hw_is_the_h100():
    assert dataclasses_fields(th.HW) == {
        "peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9, "dcn_bw": 50e9, "hbm_bytes": 80e9,
    }
    t = th.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert t["dominant"] == "memory_s"
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["roofline_fraction"] == pytest.approx(2.0 / 3.5)
