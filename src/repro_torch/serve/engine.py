"""Batched LM serving engine: continuous batching over fixed cache slots.

Port of ``repro/serve/engine.py``.  A fixed pool of ``max_batch`` cache
slots; each incoming request is prefilled token by token through the shared
decode step into a free slot; one ``decode_step`` advances every slot each
tick; finished sequences free their slots at once (continuous batching).

Weights can be served quantized (``PrecisionPolicy``): every quantized
matmul then runs the ``quant_matmul`` kernel on the card.  The caches are
preallocated on the device and written in place; admission still never
perturbs the other slots -- it works on a real copy of the caches and keeps
only the admitted slot's column of the result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.precision import PrecisionPolicy, QTensor, quantize_tree, tree_map
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import Arch

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # int32 [prompt_len]
    max_new_tokens: int = 16
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves ``arch.reduced_config``; pass ``dataclasses.replace(arch,
    reduced_config=arch.config)`` to serve at full width."""

    def __init__(
        self,
        arch: Arch,
        params,
        *,
        max_batch: int = 8,
        max_len: int = 512,
        quant: PrecisionPolicy | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.arch = arch
        self.cfg = arch.reduced_config
        params = tree_map(
            lambda _, t: t.to(self.device) if isinstance(t, (torch.Tensor, QTensor)) else t, params
        )
        self.params = quantize_tree(params, quant) if quant is not None else params
        self.max_batch = max_batch
        self.max_len = max_len
        self.caches = tfm.cache_init(self.cfg, max_batch, max_len, self.device)
        self.cur_len = np.zeros((max_batch,), np.int32)  # host copy; uploaded each step
        self.slots: list[Request | None] = [None] * max_batch
        self.last_token = np.zeros((max_batch,), np.int32)
        self.decode_steps = 0

    def _decode(self, tokens: np.ndarray) -> torch.Tensor:
        tok = torch.from_numpy(tokens[:, None].astype(np.int64)).to(self.device)
        cur_len = torch.from_numpy(self.cur_len).to(self.device)
        logits, self.caches = tfm.decode_step(self.cfg, self.params, self.caches, tok, cur_len)
        self.decode_steps += 1
        return logits

    # -- admission ---------------------------------------------------------
    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot (returns False when full).

        Prefill runs token by token through the shared decode step, then every
        *other* slot's cache column and length are restored from a snapshot,
        so admission never perturbs in-flight sequences.
        """
        slot = self._free_slot()
        if slot is None:
            return False
        snap_caches = tree_map(lambda _, c: c.clone(), self.caches)
        snap_len = self.cur_len.copy()
        self.cur_len[slot] = 0
        for _, c in tree_leaves(self.caches):
            c[:, slot].zero_()
        for t in req.prompt:
            tok = self.last_token.copy()
            tok[slot] = int(t)
            logits = self._decode(tok)
            self.cur_len[slot] += 1
        nxt = int(torch.argmax(logits[slot, -1]))
        # keep the admitted slot's column of the new caches, the snapshot elsewhere
        for (_, new), (_, old) in zip(tree_leaves(self.caches), tree_leaves(snap_caches)):
            old[:, slot] = new[:, slot]
        self.caches = snap_caches
        slot_len = self.cur_len[slot]
        self.cur_len = snap_len
        self.cur_len[slot] = slot_len
        self.last_token[slot] = nxt
        req.generated.append(nxt)
        self.slots[slot] = req
        return True

    # -- decode tick -------------------------------------------------------
    def tick(self) -> list[Request]:
        """One decode step for all slots; returns the requests that finished."""
        if not any(s is not None for s in self.slots):
            return []
        logits = self._decode(self.last_token)
        self.cur_len += np.asarray([1 if s is not None else 0 for s in self.slots], np.int32)
        finished = []
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated.append(int(nxt[i]))
            self.last_token[i] = int(nxt[i])
            if len(req.generated) >= req.max_new_tokens or int(self.cur_len[i]) >= self.max_len - 1:
                req.done = True
                finished.append(req)
                self.slots[i] = None
        return finished

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve a request list to completion with continuous batching."""
        pending = list(requests)
        done: list[Request] = []
        while pending or any(s is not None for s in self.slots):
            while pending and self.admit(pending[0]):
                pending.pop(0)
            done.extend(self.tick())
        return done
