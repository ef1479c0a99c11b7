"""The port's ``distributed/structural.py`` against the JAX package's: every
public function equal, number for number, for all ten architectures at
their full configs, every shape of ``SHAPES``, both dry-run meshes, and
``quant_bits`` None / 8 / 4 with and without ``serve_optimized``; and the
nameplate parameter counts that ``tests/test_models.py`` holds the JAX
configs to.  Pure arithmetic on templates: nothing is allocated.
"""

import dataclasses

import pytest

from repro.distributed import structural as js
from repro.models.registry import SHAPES as J_SHAPES
from repro.models.registry import get_arch as j_get_arch
from repro.models.registry import list_archs as j_list_archs
from repro_torch.distributed import structural as ts
from repro_torch.models.registry import SHAPES, get_arch, list_archs

ARCHS = sorted(j_list_archs())

# tests/test_models.py::test_param_counts_match_scale
NAMEPLATE = {
    "jamba-v0.1-52b": (45e9, 60e9),
    "phi3-medium-14b": (12e9, 16e9),
    "nemotron-4-15b": (13e9, 18e9),
    "gemma2-27b": (24e9, 31e9),
    "stablelm-1.6b": (1.3e9, 2.0e9),
    "mamba2-780m": (0.6e9, 1.0e9),
    "qwen2-vl-2b": (1.2e9, 2.3e9),
    "granite-moe-1b-a400m": (0.8e9, 1.6e9),
    "qwen2-moe-a2.7b": (11e9, 17e9),
    "whisper-medium": (0.6e9, 0.9e9),
}


def test_the_port_registers_jax_s_ten_archs():
    assert list_archs() == ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("name", ARCHS)
def test_param_bytes_count_and_nameplate(name):
    t, j = get_arch(name), j_get_arch(name)
    for which in ("config", "reduced_config"):
        assert ts.param_count(t, getattr(t, which)) == js.param_count(j, getattr(j, which))
        assert ts.param_bytes(t, getattr(t, which)) == js.param_bytes(j, getattr(j, which))
        assert ts._active_param_count(t, getattr(t, which)) == js._active_param_count(
            j, getattr(j, which)
        )
    lo, hi = NAMEPLATE[name]
    assert lo <= ts.param_count(t) <= hi


@pytest.mark.parametrize("name", ARCHS)
def test_flops_traffic_and_capacity_equal_jax_s(name):
    t, j = get_arch(name), j_get_arch(name)
    for shape_name, shape in SHAPES.items():
        jshape = J_SHAPES[shape_name]
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        assert ts.model_flops(t, shape) == js.model_flops(j, jshape)
        for multi_pod in (False, True):
            assert ts._mesh_factors(multi_pod) == js._mesh_factors(multi_pod)
            for bits in (None, 8, 4):
                for serve in (False, True):
                    kw = dict(multi_pod=multi_pod, quant_bits=bits, serve_optimized=serve)
                    assert ts.structural_bytes(t, shape, **kw) == js.structural_bytes(j, jshape, **kw)
                kw = dict(multi_pod=multi_pod, quant_bits=bits)
                assert ts.capacity_bytes(t, shape, **kw) == js.capacity_bytes(j, jshape, **kw)
                assert ts.capacity_bytes_serve_optimized(t, shape, **kw) == (
                    js.capacity_bytes_serve_optimized(j, jshape, **kw)
                )


def test_whisper_cells_count_the_encoder():
    """whisper-medium's prefill at 32k: the attention term is the encoder's
    24 layers alone, and the caches (self 448 deep, cross 32k) are written."""
    arch = get_arch("whisper-medium")
    cfg = arch.config
    got = ts.structural_bytes(arch, SHAPES["prefill_32k"])
    tokens_loc = 32 / 16 * 32_768
    assert got["attention"] == 4.0 * tokens_loc * 32_768 * 1.0 * 2.0 * cfg.n_enc_layers
    # k and v in bf16 for the self and cross caches, and each cache's int32 len [B]
    per_layer = 2 * 32 * (cfg.dec_max_len + 32_768) * cfg.n_heads * cfg.d_head * 2 + 2 * 32 * 4
    assert got["cache_write"] == cfg.n_dec_layers * per_layer / 256
    assert ts.model_flops(arch, SHAPES["train_4k"]) == 6.0 * ts.param_count(arch) * 256 * 4096
