"""Multi-pod dry run: one meta-device pass of every (arch x shape x mesh) cell.

Port of ``repro/launch/dryrun.py``.  JAX lowers and compiles each cell on
512 forced host devices and reads XLA's ``memory_analysis()``,
``cost_analysis()`` and HLO text.  The port has no compiler: it runs the
real sharded step (``launch/steps.py``'s builders over ``models/sharded*.py``)
once, eagerly, on the production mesh built from the ``meta`` device
(``make_production_mesh(device="meta")``), at full size and full depth.
Meta tensors carry shapes and dtypes and allocate nothing, so the pass needs
no card.  While the step runs, :func:`count_step` records

  * the FLOPs of every operation (``torch.utils.flop_counter``'s formulas:
    mm, addmm, bmm, baddbmm, convolution, SDPA), forward and backward, and
    of every kernel call, as the kernel wrappers report it
    (``kernels/work.py``: ``quant_matmul`` 2 M K N, ``flash_attention`` 4 B
    Hq D times the pairs its masks keep);
  * the operand + result bytes of every dispatched operation and kernel,
    unfused (view ops move nothing and count nothing);
  * every collective ``distributed/spmd.py`` issues, with its ring-cost wire
    bytes (``spmd.count_collectives``), including the backward collectives;
  * the live bytes each shard holds, keyed by storage (a view counts once):
    a storage belongs to the shards of its largest input, a
    collective's outputs to the shards that receive them, and a storage
    held by several shards counts on each.  A storage made with no tensor
    input (``torch.empty``, ``arange``) is attributed at its first use.

The step's arguments come from the ``StepBundle``'s templates as meta
tensors placed by their specs (parameters, both AdamW moments made shard
by shard, batch, caches), as JAX's lowered arguments carry their
shardings, so placement lies outside the counted window.  The port's loops
are Python loops, so one full-depth pass counts every trip: there are no 1-
and 2-group probes to extrapolate from (``n_groups`` is recorded as JAX
records it).  The same counters run on a real pass on the card, where they
check what the meta pass predicts (``chip_smoke.py`` phase 19).

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<variant>].json``
with JAX's record keys where their meaning carries over; ``pass_s`` (the
pass's wall) replaces ``lower_s`` / ``compile_s``, and
``bytes_per_device_hlo`` is the unfused operand + result bytes above.

The pass runs every shard's operations one at a time on the host: 256 or
512 shards, a 16-way all-gather 16 ``.to`` calls a shard.  A functional
op on meta tensors is replayed from the metadata of the first shard that
ran it (PyTorch's meta functions are mostly Python), which makes a
full-size pass about 3x faster.  Walls on one core of an Intel Xeon host: stablelm-1.6b
decode_32k serve_q8 41 s, train_4k 378 s; ``PERF.md`` (§6) lists the
cells measured.  A train
cell of a large arch takes minutes to tens of minutes, so ``--all --mesh
both`` (70 cells) is a run of hours: run the cells you need.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.precision import PrecisionPolicy, QTensor
from repro_torch.distributed import spmd
from repro_torch.distributed.hlo_analysis import HW, roofline_terms
from repro_torch.distributed.sharding import NamedSharding, activation_rules
from repro_torch.distributed.structural import (
    capacity_bytes,
    capacity_bytes_serve_optimized,
    model_flops,
    structural_bytes,
)
from repro_torch.kernels import work
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (
    build_decode_step,
    build_prefill_step,
    build_train_step,
    init_opt_state,
)
from repro_torch.models.registry import SHAPES, get_arch, list_archs
from repro_torch.models.transformer import layer_pattern
from repro_torch.models.whisper import WhisperConfig
from repro_torch.train import optimizer as opt_lib

__all__ = [
    "StepCounter",
    "count_step",
    "placed_args",
    "apply_variant_cfg",
    "build_step",
    "run_cell",
    "main",
]

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------


class _NoMemo(Exception):
    pass


_FRESH: dict = {}


def _fresh(func) -> bool:
    """Whether ``func`` returns new tensors only: no view, no mutated or
    aliased argument, every result a ``Tensor``."""
    r = _FRESH.get(func)
    if r is None:
        schema = func._schema
        r = _FRESH[func] = (
            not func.is_view
            and all(a.alias_info is None for a in schema.arguments)
            and len(schema.returns) > 0
            and all(str(x.type) == "Tensor" and x.alias_info is None for x in schema.returns)
        )
    return r


def _meta_key(x, seen: list):
    """``x``'s metadata; appends to ``seen`` for each meta tensor or device."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NoMemo
        seen.append(True)
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(y, seen) for y in x)
    if isinstance(x, torch.device):
        if x.type != "meta":
            raise _NoMemo
        seen.append(True)
        return (torch.device, x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.memory_format, torch.layout)):
        return (type(x), x)
    raise _NoMemo


def _memo_key(func, args, kwargs):
    """A key of ``func`` on meta tensors of these shapes, strides and dtypes
    (or making a meta tensor) with these other arguments, or ``None`` where
    the call cannot be replayed from its metadata."""
    if not _fresh(func):
        return None
    seen: list = []
    try:
        key = (func, _meta_key(args, seen), tuple(sorted((k, _meta_key(v, seen)) for k, v in kwargs.items())))
    except _NoMemo:
        return None
    return key if seen else None


def _dense_nbytes(t: torch.Tensor) -> int:
    """The storage bytes ``torch.empty_strided`` gives ``t``'s shape and strides."""
    if t.numel() == 0:
        return 0
    return (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))) * t.element_size()


def _flat_tensors(x, out: list) -> list:
    """The tensors in an op's (nested list / tuple) arguments or results."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat_tensors(y, out)
    return out


class StepCounter(TorchDispatchMode):
    """FLOPs, bytes and per-shard live bytes of everything dispatched while
    the mode is on, for a mesh of ``n_shards`` (see the module docstring).

    ``flops`` / ``bytes`` are totals over every shard; ``kernels`` holds
    ``{name: {"calls", "flops", "bytes"}}`` of the kernel calls (their ops
    are not counted again).  ``live[i]`` / ``peak[i]`` are shard ``i``'s
    live and peak bytes.  On one shard every storage is shard 0's."""

    def __init__(self, n_shards: int):
        super().__init__()
        self.n = n_shards
        self.flops = 0
        self.bytes = 0
        self.kernels: dict[str, dict] = {}
        self.live = [0] * n_shards
        self.peak = [0] * n_shards
        self._holders: dict[int, tuple] = {}  # storage -> shards (() until first use)
        self._sizes: dict[int, int] = {}
        self._kernel_holders: list = []  # the operands' shards of each open kernel call
        # meta outputs (shape, stride, dtype) and FLOPs of functional ops by
        # their inputs' metadata: 256 shards repeat every op, and PyTorch's
        # meta functions are mostly Python
        self._memo: dict = {}

    # -- storages ----------------------------------------------------------
    def _add(self, key: int, shards: tuple) -> None:
        nb = self._sizes[key]
        for s in shards:
            self.live[s] += nb
            if self.live[s] > self.peak[s]:
                self.peak[s] = self.live[s]

    def _free(self, key: int) -> None:
        shards = self._holders.pop(key, ())
        nb = self._sizes.pop(key, 0)
        for s in shards:
            self.live[s] -= nb

    def track(self, t: torch.Tensor, shards: tuple | None = None) -> int:
        """Start counting ``t``'s storage (held by ``shards``; ``None``: not
        yet known); returns its key."""
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._sizes:
            self._sizes[key] = st.nbytes()
            self._holders[key] = ()
            weakref.finalize(st, self._free, key)
            if shards is None and self.n == 1:
                shards = (0,)
        if shards is not None:
            self.hold_key(key, shards)
        return key

    def hold_key(self, key: int, shards: tuple) -> None:
        old = self._holders.get(key, ())
        if old == shards:
            return
        for s in old:
            self.live[s] -= self._sizes[key]
        self._holders[key] = shards
        self._add(key, shards)

    def hold(self, t: torch.Tensor, shards: tuple) -> None:
        """``t``'s storage is held by ``shards`` (each counts it)."""
        self.track(t, tuple(shards))

    def shard_bytes(self, tensors) -> list[int]:
        """Each shard's bytes of the distinct storages of ``tensors``."""
        out, seen = [0] * self.n, set()
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            for s in self._holders.get(st._cdata, ()):
                out[s] += st.nbytes()
        return out

    # -- kernels (kernels/work.py) -----------------------------------------
    def kernel_begin(self, name: str, flops: float, nbytes: float, operands=()) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes += int(nbytes)
        # what the call allocates belongs to the shard of its operands
        self._kernel_holders.append(self._holder_of(operands)[0])

    def kernel_end(self) -> None:
        self._kernel_holders.pop()

    def _holder_of(self, tensors) -> tuple:
        """``(shards, pending keys)``: the shards of the largest of
        ``tensors`` that has any (``None`` if none has), and the storages
        among them not yet attributed."""
        holder, size, pending = None, -1, []
        for t in tensors:
            key = self.track(t)
            shards = self._holders[key]
            nb = t.numel() * t.element_size()
            if not shards:
                pending.append(key)
            elif nb > size:
                holder, size = shards, nb
        return holder, pending

    # -- operations --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _memo_key(func, args, kwargs)
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            metas, flops = hit
            out = tuple(torch.empty_strided(shape, stride, dtype=dt, device="meta") for shape, stride, dt in metas)
            out = out[0] if len(out) == 1 else out
        else:
            out = func(*args, **kwargs)
            flops = None
        ins = _flat_tensors((args, list(kwargs.values())), [])
        outs = _flat_tensors(out, [])
        if not self._kernel_holders:
            if flops is None:
                packet = func._overloadpacket
                flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) if packet in flop_registry else 0
                fresh = key is not None and not (
                    {t.untyped_storage()._cdata for t in outs} & {t.untyped_storage()._cdata for t in ins}
                )  # ``_unsafe_view`` returns its input's storage under a fresh schema
                if fresh and all(t.untyped_storage().nbytes() == _dense_nbytes(t) for t in outs):
                    self._memo[key] = (tuple((tuple(t.shape), t.stride(), t.dtype) for t in outs), flops)
            self.flops += flops
            if not func.is_view:
                self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        holder, pending = self._holder_of(ins)
        if holder is None and self._kernel_holders:
            holder = self._kernel_holders[-1]
        if holder is not None:
            for sk in pending:
                self.hold_key(sk, holder)
        for t in outs:
            sk = self.track(t)
            if holder is not None and not self._holders[sk]:
                self.hold_key(sk, holder)
        return out


@contextlib.contextmanager
def count_step(n_shards: int):
    """Count everything the block dispatches, launches and communicates on
    a mesh of ``n_shards``: yields the :class:`StepCounter`, whose
    ``collectives`` is the block's :class:`~repro_torch.distributed.spmd.
    CollectiveRecorder`."""
    counter = StepCounter(n_shards)
    with spmd.count_collectives(hold=counter.hold) as rec, work.listening(counter), counter:
        counter.collectives = rec
        yield counter


def placed_args(bundle, device="meta"):
    """The step's arguments from ``bundle``'s templates, zeros: on a mesh,
    every leaf :class:`~repro_torch.distributed.spmd.Sharded` over its spec
    with one block a shard on ``device`` (each shard's own storage); on one
    device whole tensors.  A train step gets the step builder's default
    AdamW state, made shard by shard from the parameters."""
    mesh = bundle.mesh
    specs = bundle.specs or (None,) * len(bundle.abstract_args)

    def block(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def leaf(template, spec):
        if isinstance(template, QTensor):
            q = leaf(template.q, spec.q if spec is not None else None)
            s = leaf(template.scale, spec.scale if spec is not None else None)
            return QTensor(q=q, scale=s, bits=template.bits, shape=template.shape)
        shape, dtype = template
        if mesh is None:
            return block(shape, dtype)
        spec = spmd._full_spec(spec, len(shape))
        NamedSharding(mesh, spec)  # a spec that names an axis twice raises, as placement does
        sizes = tuple(n // mesh.axis_size(e) for n, e in zip(shape, spec))
        return spmd.Sharded([block(sizes, dtype) for _ in range(mesh.size)], mesh, spec, tuple(shape))

    def tree(templates, specs):
        if isinstance(templates, dict):
            return {k: tree(v, specs[k] if specs is not None else None) for k, v in templates.items()}
        return leaf(templates, specs)

    if bundle.name.startswith("train:"):
        params = tree(bundle.abstract_args[0], specs[0])
        state = init_opt_state(opt_lib.adamw(3e-4), params)
        return params, state, tree(bundle.abstract_args[2], specs[2])
    return tuple(tree(t, s) for t, s in zip(bundle.abstract_args, specs))


# ---------------------------------------------------------------------------
# Cells (JAX's run_cell, step for step)
# ---------------------------------------------------------------------------


def _with_groups(cfg, k: int):
    """A config with k repeat groups (probe depth)."""
    if isinstance(cfg, WhisperConfig):
        return dataclasses.replace(cfg, n_enc_layers=k, n_dec_layers=k)
    return dataclasses.replace(cfg, n_layers=k * len(layer_pattern(cfg)))


def _total_groups(cfg) -> int:
    if isinstance(cfg, WhisperConfig):
        return cfg.n_enc_layers  # enc and dec scale together in probes
    return cfg.n_layers // len(layer_pattern(cfg))


def apply_variant_cfg(arch, shape, variant: str):
    """Config-level changes a variant implies (shared by the step builder and
    the structural-bytes accounting)."""
    cfg = arch.config
    if isinstance(cfg, WhisperConfig):
        return arch
    if variant.endswith("_kv8"):
        cfg = dataclasses.replace(cfg, kv_cache_bits=8)
    if "gqa" in variant:
        cfg = dataclasses.replace(cfg, gqa_flat=True)
    if variant in ("moe_gqa", "ep_megatron") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, shard_experts="megatron"))
    if shape.kind == "train":
        if variant in ("headrep", "combo"):
            cfg = dataclasses.replace(cfg, shard_head_dim=False)
        if variant in ("ep_data", "combo") and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, shard_experts="fsdp"))
    if cfg is not arch.config:
        arch = dataclasses.replace(arch, config=cfg)
    return arch


def build_step(arch, shape, mesh, *, quant_bits: int | None = None, variant: str = "baseline"):
    """Variants (the section-Perf hillclimb knobs):

      baseline    -- training layout everywhere (f32 FSDP+TP params)
      serve_opt   -- bf16 TP-only serving params (kills per-step all-gathers)
      serve_q8/q4 -- serve_opt + int8/int4 quant_matmul weights (the paper's
                     precision knob applied at LM scale)
      *_kv8       -- int8 KV cache on top (state-precision knob)
      bf16gather  -- train: cast params to bf16 at step start so FSDP
                     all-gathers move half the bytes
      headrep     -- train: replicate the embed/lm_head d_model axis so the
                     chunked-CE head matmul contracts locally
      ep_data / ep_megatron -- MoE expert-sharding alternatives
      combo       -- bf16gather + headrep + ep_data
    """
    arch = apply_variant_cfg(arch, shape, variant)
    serve_optimized = variant.startswith("serve")
    base_variant = variant.removesuffix("_kv8")
    if base_variant == "serve_q8":
        quant_bits = 8
    elif base_variant == "serve_q4":
        quant_bits = 4
    quant = (
        PrecisionPolicy(rules=(("(wq|wk|wv|wo|w_gate|w_up|w_down|in_proj|out_proj)$", quant_bits),))
        if quant_bits
        else None
    )
    if shape.kind == "train":
        return build_train_step(
            arch, shape, mesh, bf16_gather=variant in ("bf16gather", "combo")
        )
    if shape.kind == "prefill":
        return build_prefill_step(arch, shape, mesh, quant=quant, serve_optimized=serve_optimized)
    shard_seq = shape.name == "long_500k"
    return build_decode_step(
        arch, shape, mesh, quant=quant, shard_cache_seq=shard_seq, serve_optimized=serve_optimized
    )


def _tensors(tree) -> list[tuple[torch.Tensor, int]]:
    """``(tensor, shard)`` for every tensor of a step's arguments or
    results (Sharded blocks by their shard, other tensors shard 0; QTensor
    payloads, optimizer lists, dicts, tuples)."""
    if isinstance(tree, torch.Tensor):
        return [(tree, 0)]
    if isinstance(tree, spmd.Sharded):
        return [(t, i) for i, t in enumerate(tree.shards)]
    if isinstance(tree, QTensor):
        return _tensors(tree.q) + _tensors(tree.scale)
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in _tensors(v)]
    return []


def run_pass(bundle, args=None, *, device="meta") -> dict:
    """One counted pass of ``bundle``'s step on ``args`` (default: made
    from its templates on ``device``, :func:`placed_args`): the totals, the
    largest shard's argument / output / peak bytes, the collectives, the
    kernels and the wall.  On the ``meta`` device nothing is allocated."""
    n = bundle.mesh.size if bundle.mesh is not None else 1
    args = placed_args(bundle, device) if args is None else args
    t0 = time.perf_counter()
    with count_step(n) as c:
        for t, i in _tensors(args):
            c.hold(t, (i,))
        arg_bytes = max(c.shard_bytes(t for t, _ in _tensors(args)))
        out = bundle.jitted(*args)
        del args
        out_bytes = max(c.shard_bytes(t for t, _ in _tensors(out)))
        del out
    coll = c.collectives.stats()
    return {
        "flops": c.flops,
        "bytes": c.bytes,
        "n_shards": n,
        "memory": {
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "peak_memory_in_bytes": int(max(c.peak)),
        },
        "collectives": coll,
        "backward_collectives": c.collectives.stats(backward=True).summary(),
        "kernels": c.kernels,
        "wall_s": time.perf_counter() - t0,
    }


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, *, quant_bits=None, variant="baseline", out_dir=OUT_DIR, verbose=True):
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    record = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh_name,
        "variant": variant,
        "kind": shape.kind,
        "status": "skipped",
    }
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    out_path = out_dir / f"{arch_name}__{shape_name}__{mesh_name}{suffix}.json"

    if not arch.runs_shape(shape_name):
        record["reason"] = arch.skip_reason
        out_path.write_text(json.dumps(record, indent=2))
        if verbose:
            print(f"[dryrun] SKIP {arch_name} x {shape_name} ({arch.skip_reason})")
        return record

    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        with activation_rules(mesh):
            # ---- one full-depth pass: every trip of every loop counted ----
            bundle = build_step(arch, shape, mesh, quant_bits=quant_bits, variant=variant)
            p = run_pass(bundle)
            ng = _total_groups(arch.config)
            flops = p["flops"] / p["n_shards"]
            bytes_accessed = p["bytes"] / p["n_shards"]
            surface = p["collectives"]
            wire = surface.per_device_wire_bytes

            # structural (fusion-aware lower-bound) memory model + capacity
            arch_v = apply_variant_cfg(arch, shape, variant)
            serve_opt = variant.startswith("serve")
            q_eff = {"serve_q8": 8, "serve_q4": 4}.get(variant.removesuffix("_kv8"), quant_bits)
            struct = structural_bytes(
                arch_v, shape, multi_pod=multi_pod, quant_bits=q_eff,
                serve_optimized=serve_opt, cfg=arch_v.config,
            )
            if serve_opt:
                cap = capacity_bytes_serve_optimized(
                    arch_v, shape, multi_pod=multi_pod, quant_bits=q_eff, cfg=arch_v.config
                )
            else:
                cap = capacity_bytes(arch_v, shape, multi_pod=multi_pod, quant_bits=q_eff, cfg=arch_v.config)
            mf = model_flops(arch, shape)

            terms = roofline_terms(flops, struct["total"], wire)
            terms_hlo = roofline_terms(flops, bytes_accessed, wire)

            record.update(
                status="ok",
                n_devices=int(mesh.devices.size),
                n_groups=ng,
                pass_s=round(p["wall_s"], 2),
                flops_per_device=flops,
                model_flops_global=mf,
                model_flops_per_device=mf / mesh.devices.size,
                useful_flops_ratio=(mf / mesh.devices.size) / flops if flops else None,
                bytes_per_device_hlo=bytes_accessed,
                bytes_per_device_structural=struct,
                wire_bytes_per_device=wire,
                memory=p["memory"],
                capacity_structural=cap,
                fits_hbm=cap["total"] <= HW.hbm_bytes,
                collectives_surface=surface.summary(),
                backward_collectives=p["backward_collectives"],
                kernels=p["kernels"],
                roofline=terms,
                roofline_hlo_bytes=terms_hlo,
            )
    except Exception as e:  # record the failure; dry-run failures are bugs
        record.update(status="error", error=f"{type(e).__name__}: {e}", traceback=traceback.format_exc()[-2000:])
    record["wall_s"] = round(time.time() - t0, 2)
    out_path.write_text(json.dumps(record, indent=2))
    if verbose:
        if record["status"] == "ok":
            r = record["roofline"]
            print(
                f"[dryrun] OK {arch_name} x {shape_name} x {mesh_name}{suffix} "
                f"({record['wall_s']}s) peak={record['memory'].get('peak_memory_in_bytes',0)/1e9:.2f}GB "
                f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                f"collective={r['collective_s']:.3e}s dom={r['dominant']}"
            )
        else:
            print(f"[dryrun] {record['status'].upper()} {arch_name} x {shape_name} x {mesh_name}: {record.get('error','')}")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all four)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="every (arch x shape)")
    ap.add_argument("--quant-bits", type=int, default=None, help="serve-side weight quantization (4 or 8)")
    ap.add_argument("--variant", default="baseline", help="label for optimized re-runs")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_err = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(
                    arch, shape, mp, quant_bits=args.quant_bits, variant=args.variant,
                    out_dir=pathlib.Path(args.out),
                )
                n_ok += rec["status"] == "ok"
                n_err += rec["status"] == "error"
                n_skip += rec["status"] == "skipped"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
