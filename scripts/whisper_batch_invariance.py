#!/usr/bin/env python3
"""Where whisper-medium's request 0 decoded alone (B = 1) parts from its row
of a batch of 4, at full width, int8, as ``chip_smoke.py`` phase 15a runs it.

    python3 scripts/whisper_batch_invariance.py   # one card

The same seeds as phase 15a: parameters from ``manual_seed(0)``, 4 clips of
4096 frames from ``manual_seed(3)``.  Prints, each line with the card's name
and power limit:

1. whether the two prefills give request 0 the same cross K/V (every layer);
2. op by op, for every operation of decode step 0 (layer norms and their
   mean and variance, every ``qdot``, the decode attention's scores,
   softmax and probability-weighted sum, the logits' einsum), whether the
   op gives row 0 the same bits when it runs on row 0 alone as it does in
   the batch of 4, from the same input: the ops whose result depends on the
   batch size;
3. the real B = 1 and B = 4 runs of decode step 0 side by side: the first
   op whose row-0 output differs, and each decoder layer's hidden state's
   distance (share of max |h|);
4. over 32 greedy steps from token 0: the tokens, each step's logits
   distance (share of max |logit|) and the batched row's top-2 margin (same
   share).
"""

import contextlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import mlp as mlp_mod  # noqa: E402
from repro_torch.models import whisper as wh_mod  # noqa: E402

STEPS = 32


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    top = float(b.abs().max())
    return float((a - b).abs().max()) / top if top else float((a - b).abs().max())


def row0(a, B: int):
    """``a`` with its batch axis cut to request 0 (tensors whose first axis is
    B, inside dicts too); weights pass through."""
    if isinstance(a, torch.Tensor):
        return a[:1] if a.dim() and a.shape[0] == B else a
    if isinstance(a, dict):
        return {k: row0(v, B) for k, v in a.items()}
    if isinstance(a, (tuple, list)):
        return type(a)(row0(v, B) for v in a)
    return a


@contextlib.contextmanager
def patched(wrap):
    """Every op of the decode path wrapped by ``wrap(name, fn)`` while the
    block runs."""
    sites = [(wh_mod, "layer_norm"), (wh_mod, "qdot"), (mlp_mod, "qdot"),
             (attn_mod, "decode_attend"), (wh_mod, "_logits")]
    saved = [getattr(m, n) for m, n in sites]
    try:
        for (m, n), f in zip(sites, saved):
            setattr(m, n, wrap(f"{m.__name__.rsplit('.', 1)[-1]}.{n}", f))
        yield
    finally:
        for (m, n), f in zip(sites, saved):
            setattr(m, n, f)


def decode_attend_stages(q, cache):
    """``decode_attend``'s stages (its code, stage by stage): scores,
    probabilities, output."""
    Sk, D = cache["k"].shape[1], q.shape[-1]
    valid = torch.arange(Sk, device=q.device)[None] < cache["len"][:, None]
    scores = attn_mod._gqa_scores(q, cache["k"], D**-0.5)
    probs = torch.softmax(torch.where(valid[:, None, None, None], scores, cs.NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cache["v"].to(torch.float32))
    return {"scores": scores, "softmax": probs, "pv_einsum": out}


def op_invariance(B: int, found: dict):
    """A wrapper that runs each op once more on row 0 alone and records, per
    op, whether row 0's bits differ and by how much."""
    state = {"ln": 0}

    def note(name, batched, alone):
        same = torch.equal(batched[:1], alone)
        d = found.setdefault(name, {"calls": 0, "differ": 0, "max_rel": 0.0, "first": None})
        d["calls"] += 1
        if not same:
            d["differ"] += 1
            d["max_rel"] = max(d["max_rel"], rel(alone, batched[:1]))
            if d["first"] is None:
                d["first"] = f"layer {state['ln'] // 3}"

    def wrap(name, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            alone = fn(*row0(args, B), **row0(kw, B))
            note(name, out, alone)
            if name.endswith("layer_norm"):
                xf = args[0].float()
                x1 = xf[:1]
                note("layer_norm: mean", xf.mean(-1), x1.mean(-1))
                note("layer_norm: var", xf.var(-1, unbiased=False), x1.var(-1, unbiased=False))
                state["ln"] += 1
            elif name.endswith("decode_attend"):
                full, one = decode_attend_stages(*args), decode_attend_stages(*row0(args, B))
                for k in full:
                    note(f"decode_attend: {k}", full[k], one[k])
            elif name.endswith("_logits"):
                h = wh_mod.layer_norm(args[1], args[0]["dec_norm"]["w"], args[0]["dec_norm"]["b"])
                e = args[0]["embed"].float()
                note("_logits: einsum", torch.einsum("bsd,vd->bsv", h.float(), e),
                     torch.einsum("bsd,vd->bsv", h[:1].float(), e))
            return out
        return run

    return wrap


def tracer(trace: list):
    """A wrapper that records each op's row-0 output in order."""
    def wrap(name, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            trace.append((name, out[:1].clone()))
            return out
        return run
    return wrap


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cs.build.load_all()
    arch = cs.get_arch(cs.WHISPER_ARCH)
    qparams = cs.quantize_tree(
        arch.init_params(torch.Generator(device=cs.DEVICE).manual_seed(0)), cs.lm_policy(8))
    prefill, decode = cs.whisper_steps(arch, cs.WHISPER_FRAMES, cs.WHISPER_B)
    shape = cs.ShapeSpec("prefill", cs.WHISPER_FRAMES, cs.WHISPER_B, "prefill")
    batch = arch.input_concrete(torch.Generator(device=cs.DEVICE).manual_seed(3), shape, arch.config)
    B = cs.WHISPER_B
    frames1 = {"audio_frames": batch["audio_frames"][:1]}

    c4, c1 = prefill(qparams, batch), prefill(qparams, frames1)
    cross = {k: torch.equal(c4["cross"][k][:, :1], c1["cross"][k]) for k in ("k", "v")}
    print(f"prefill: request 0's cross K/V bit-equal at B = 1 and B = {B} (every layer): "
          f"{cross}; on {smi}", flush=True)

    step0 = {"tokens": torch.zeros(B, 1, dtype=torch.int32, device=cs.DEVICE),
             "cur_len": torch.zeros(B, dtype=torch.int32, device=cs.DEVICE)}
    found: dict = {}
    caches = prefill(qparams, batch)
    with patched(op_invariance(B, found)):
        decode(qparams, caches, step0)
    print(f"decode step 0, each op on row 0 alone against row 0 in the batch of {B}, from the "
          f"same input (calls; calls whose bits differ; max distance as a share of max |out|; "
          f"first layer that differs): on {smi}", flush=True)
    for name, d in found.items():
        print(f"  {name}: {d['calls']} calls, {d['differ']} differ, max {d['max_rel']:.3e}, "
              f"first {d['first']}", flush=True)

    traces: dict = {}
    for b, frames in ((B, batch), (1, frames1)):
        traces[b] = []
        caches = prefill(qparams, frames)
        with patched(tracer(traces[b])):
            decode(qparams, caches, {k: v[:b] for k, v in step0.items()})
    first = next(((i, n) for i, ((n, a), (_, c)) in enumerate(zip(traces[B], traces[1]))
                  if not torch.equal(a, c)), None)
    ln_in = [i for i, (n, _) in enumerate(traces[B]) if n.endswith("layer_norm")]
    per_layer = [rel(traces[1][i][1], traces[B][i][1]) for i in ln_in[::3]]
    print(f"decode step 0, the real B = 1 and B = {B} runs: {len(traces[B])} ops, the first "
          f"whose row-0 output differs: {first} (op index, name); each layer's norm1 output "
          f"distance, layer 0 on, then the final norm's: {[f'{e:.2e}' for e in per_layer]}; logits "
          f"{rel(traces[1][-1][1], traces[B][-1][1]):.3e}; on {smi}", flush=True)

    rows: dict = {B: [], 1: []}
    toks = {B: cs.greedy(decode, qparams, prefill(qparams, batch), B, STEPS, rows[B]),
            1: cs.greedy(decode, qparams, prefill(qparams, frames1), 1, STEPS, rows[1])}
    dist, margin = [], []
    for g, w in zip(rows[1], rows[B]):
        scale = float(w.abs().max())
        dist.append(float((g - w).abs().max()) / scale)
        top2 = w.topk(2).values
        margin.append(float(top2[0] - top2[1]) / scale)
    print(f"{STEPS} greedy steps: tokens equal {torch.equal(toks[1][0], toks[B][0])}; logits "
          f"distance by step {[f'{e:.2e}' for e in dist]} (max {max(dist):.3e}); the batched "
          f"row's top-2 margin by step {[f'{m:.2e}' for m in margin]} (min {min(margin):.3e}); "
          f"on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
