"""A decode session of the port's language model: one batch's cache,
decoded a step at a time through ``models.lm.decode_step``, and on a card
replayed from CUDA graphs of the step.

:class:`DecodeSession` holds a config, its parameters and a batch's cache
(``lm.init_cache``, filled by ``lm.prefill``). On a CUDA device, for an MLA
decoder (whose step reads its position from a device tensor,
``attention.position``), the session records a step as CUDA graphs at the
second step of a token shape and replays them from then on. It records two
graphs of the step, in one memory pool: the step as it runs, and the step
with the external events of its spans (``obs.template``). While spans are
recorded it replays the second, so a traced step is a replay, and each of
its stages has a device interval of its own (``obs.replayed``). A graph
reads the tensors of the parameters and the cache it was recorded on: a
write into them shows at the next replay, a leaf put in their place does
not.

Spans: the root ``serve.decode`` (``engine``: the session's serial,
``queries``: the batch) around each step, and the step's own inside it.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.models import lm

_SERIALS = itertools.count(1)


class _Graph:
    """One recorded step: its graph, the static tokens and position it
    reads, the logits it writes, and the template of its spans (empty for
    the graph without events)."""

    __slots__ = ("graph", "tokens", "pos", "logits", "spans")

    def __init__(self, graph: torch.cuda.CUDAGraph, tokens: torch.Tensor, pos: torch.Tensor,
                 logits: torch.Tensor, spans: List):
        self.graph, self.tokens, self.pos, self.logits, self.spans = (graph, tokens, pos,
                                                                       logits, spans)


class DecodeSession:
    """Decode steps of one batch over ``cache``."""

    def __init__(self, cfg, params, cache: Dict[str, torch.Tensor]):
        self.cfg, self.params, self.cache = cfg, params, cache
        self.serial = next(_SERIALS)
        self.device = params["embed"].device
        self.graphs = (self.device.type == "cuda" and cfg.attn_type == "mla"
                       and not isinstance(params["embed"], DTensor))
        # by the tokens' shape and dtype: None after the first, eager step
        self._graphs: Dict[tuple, Optional[Tuple[_Graph, _Graph]]] = {}
        self._pool = self._stream = None

    def step(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        """The logits ``[B, V]`` of one token for every sequence, ``tokens``
        ``[B]`` at position ``pos`` (an int); writes the cache."""
        with obs.span("serve.decode", device=self.device, engine=self.serial,
                      queries=tokens.shape[0]):
            logits = self._replay(tokens, pos)
            if logits is None:
                logits, self.cache = lm.decode_step(self.cfg, self.params, self.cache,
                                                    tokens, pos)
            return logits

    def _replay(self, tokens: torch.Tensor, pos) -> Optional[torch.Tensor]:
        """The step's logits from its graphs; None where the step runs
        eagerly: where the session keeps no graphs, and at the first step of
        a token shape, which loads the kernels and sets cuBLAS up."""
        if not self.graphs:
            return None
        key = (tuple(tokens.shape), tokens.dtype)
        if key not in self._graphs:
            self._graphs[key] = None
            return None
        if self._graphs[key] is None:
            self._graphs[key] = self._capture(tokens)
        plain, traced = self._graphs[key]
        g = traced if obs.tracing() else plain
        start = obs.clock_ns()
        # stream-ordered after the last replay, whose logits were cloned
        g.tokens.copy_(tokens)
        g.pos.fill_(int(pos))
        g.graph.replay()
        obs.replayed(g.spans, start)
        return g.logits.clone()

    def _capture(self, tokens: torch.Tensor) -> Tuple[_Graph, _Graph]:
        """Record the step on static tokens and a device position, once as
        it runs and once with its spans' events."""
        dev = tokens.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        static, at = tokens.clone(), torch.zeros(1, dtype=torch.long, device=dev)
        out = []
        for events in (False, True):
            graph = torch.cuda.CUDAGraph()
            with contextlib.ExitStack() as stack:
                spans = stack.enter_context(obs.template()) if events else []
                stack.enter_context(torch.cuda.device(dev))
                stack.enter_context(torch.cuda.graph(graph, pool=self._pool,
                                                     stream=self._stream))
                logits, _ = lm.decode_step(self.cfg, self.params, self.cache, static, at)
            out.append(_Graph(graph, static, at, logits, spans))
        return out[0], out[1]
