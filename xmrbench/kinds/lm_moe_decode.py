"""The LM MoE decode kind: a DeepSeek-V2 decoder of ``repro_torch`` on one
card (MLA without q LoRA under YaRN, leading dense layers, then MoE layers
of routed and shared experts), through its normal path
(``models.lm.prefill``, and ``models.lm.decode_step`` in a decode session,
``serving.decode.DecodeSession``, which replays the step from CUDA graphs
on the card), decoding a batch of sequences against caches that set-up
prefilled.

The loop, the mix (mode ``decode``), the ids, the judged draw, the
control and the faults are the ``lm_decode`` kind's (:mod:`lm_decode`);
what differs is the model. The configuration names the port's
architecture (``arch``), states it as run (``model``: ``ArchConfig``
field names, and ``yarn`` for the rotary scaling), and carries the
published ``config.json``'s keys at its top level: :func:`validate` holds
the run's model to each of them before anything is allocated.

Set-up draws the weights on the device in the program's layout, one draw a
stacked leaf (matrices N(0, 1) / sqrt(fan-in) as the port's initialisers
draw them, norm scales 1 + N(0, 0.1)), and checks that layout against
``lm.param_shapes``. After the prefill it reads how many experts the
program's routing touches (:meth:`Run.routing`).

The check (:meth:`Run.check`) is ``lm_decode``'s against this kind's
reference, :mod:`xmrbench.lm_moe_reference`, with one more rule, since at a
near-tie of the router a float32 program may pick the other expert as
rightly as the reference: where a judged token's gap passes an eighth of
the limit (:data:`SWAP_SHARE`: the program's gaps lie below it unless a
routing decision differs) and some MoE layer's routing margin of it (the
gap between the router's K-th and (K+1)-th logits) is under
``check.tie_margin``, the reference runs that sequence again with the
token's K-th and (K+1)-th experts swapped in that layer, one such layer at
a time (the same sequence and rows, so that every other decision rounds as
it did), and the token's gap is the least of those readings. Every judged
token is judged. ``swapped`` counts the tokens that a swapped routing
judged, at most a sixteenth of the judged (at least one); where more tokens
than that pass an eighth of the limit, nothing is run again.

The work of a step (:func:`step_work`) is counted from shapes, whatever
form computes it: every weight outside the routed experts read once (of
the embedding, the batch's rows), the routed experts at the number that
the step's T tokens touch a layer (each read once), the latent cache read
once in its dtype and its new slot written, the logits written in f32; the FLOPs
of the absorbed form and of the T * K routed pairs. :func:`moe_work` is
its MoE part (the router, the touched experts, the shared experts), which
``moe_roofline.decode`` reads. The touched experts are those that set-up
read off the program's routing: sequences that ask one prompt route alike,
so the step's T tokens touch fewer than the ``E (1 - (1 - K/E)^T)`` of
independent, uniform routing (:func:`touched_experts`), which counts where
no reading is given.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional

import torch

from xmrbench import gen, lm_moe_reference
from xmrbench.kinds import lm_decode, log, sync
from xmrbench.kinds.lm_decode import FAULTS, control_hook, fault_hooks  # noqa: F401
from xmrbench.work import Work

#: Decode steps in which set-up reads the program's routing (:meth:`Run.routing`).
ROUTING_STEPS = 16
#: The share of ``logit_gap``'s limit above which a token at a routing near-tie
#: is judged against the swapped routing too (:meth:`Run.check`).
SWAP_SHARE = 1 / 8

#: The published ``config.json``'s keys and the ``ArchConfig`` fields that
#: state them (``q_lora_rank`` null is 0; ``rope_scaling`` is ``yarn``).
PUBLISHED = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model", "num_attention_heads": "n_heads",
    "intermediate_size": "d_ff", "vocab_size": "vocab", "kv_lora_rank": "kv_lora_rank",
    "qk_rope_head_dim": "qk_rope_dim", "qk_nope_head_dim": "qk_nope_dim",
    "v_head_dim": "v_head_dim", "n_routed_experts": "n_experts",
    "num_experts_per_tok": "experts_per_token", "moe_intermediate_size": "moe_d_ff",
    "n_shared_experts": "n_shared_experts", "first_k_dense_replace": "first_k_dense",
    "norm_topk_prob": "norm_topk_prob", "routed_scaling_factor": "routed_scale",
    "rope_theta": "rope_theta", "tie_word_embeddings": "tie_embeddings",
}
#: ``rope_scaling``'s keys and the fields of the port's ``YaRN``.
ROPE_SCALING = {
    "factor": "factor", "original_max_position_embeddings": "original_max_position",
    "beta_fast": "beta_fast", "beta_slow": "beta_slow", "mscale": "mscale",
    "mscale_all_dim": "mscale_all_dim",
}


def arch_config(config: dict):
    """The port's ``ArchConfig`` as the configuration runs it: ``model`` as
    ``lm_decode.arch_config`` reads it, ``model.yarn`` in the ``YaRN``'s
    place."""
    model = dict(config["model"])
    yarn = model.pop("yarn", None)
    cfg = lm_decode.arch_config(dict(config, model=model))
    if yarn is not None:
        cfg = dataclasses.replace(cfg, yarn=dataclasses.replace(cfg.yarn, **yarn))
    return cfg


def _published_mismatches(config: dict, cfg) -> list:
    out = []
    for key, field in PUBLISHED.items():
        if key in config and config[key] != getattr(cfg, field):
            out.append(f"{key} {config[key]!r} != {field} {getattr(cfg, field)!r}")
    if "q_lora_rank" in config and (config["q_lora_rank"] or 0) != cfg.q_lora_rank:
        out.append(f"q_lora_rank {config['q_lora_rank']!r} != {cfg.q_lora_rank!r}")
    for key, field in ROPE_SCALING.items():
        want = config.get("rope_scaling", {}).get(key)
        if want is not None and want != getattr(cfg.yarn, field):
            out.append(f"rope_scaling.{key} {want!r} != yarn.{field} {getattr(cfg.yarn, field)!r}")
    return out


def validate(config: dict, mix: dict) -> None:
    cfg = arch_config(config)
    if (cfg.family != "moe" or cfg.attn_type != "mla" or cfg.q_lora_rank
            or getattr(cfg, "yarn", None) is None or not cfg.n_shared_experts
            or cfg.activations_bf16):
        raise ValueError("the reference covers f32 DeepSeek-V2 decoders only: MLA without "
                         "q LoRA under YaRN, leading dense layers, routed and shared experts")
    wrong = _published_mismatches(config, cfg)
    if wrong:
        raise ValueError("the model as run is not the published one: " + "; ".join(wrong))
    if mix["mode"] != "decode":
        raise ValueError(f"unknown mix mode {mix['mode']!r}")
    if int(mix["prompts"]) < 2 or int(mix["asks"]) < 1:
        raise ValueError("the check draws sequences of different prompts")
    if int(mix["prompts"]) * int(mix["asks"]) % 2 or int(mix["judge_sequences"]) % 2:
        raise ValueError("the check draws as many sequences in each half of the batch")
    if not 1 <= int(mix["judge_steps"]) <= min(int(mix["judge_within"]), int(mix["answer_len"])):
        raise ValueError("judge_steps outside [1, min(judge_within, answer_len)]")


def _model(cfg) -> Dict[str, float]:
    keys = ("n_layers", "d_model", "n_heads", "kv_lora_rank", "qk_rope_dim", "qk_nope_dim",
            "v_head_dim", "d_ff", "vocab", "rope_theta", "n_experts", "experts_per_token",
            "moe_d_ff", "n_shared_experts", "first_k_dense", "norm_topk_prob", "routed_scale")
    model = {k: getattr(cfg, k) for k in keys}
    model.update({f"yarn_{f.name}": getattr(cfg.yarn, f.name)
                  for f in dataclasses.fields(cfg.yarn)})
    model["cache_bytes"] = torch.empty((), dtype=cfg.activ_dtype).element_size()
    return model


def make_weights(cfg, seed: int, device) -> dict:
    """The weights in the program's layout, one draw a stacked leaf: the
    leading dense layers under ``dense_layers``, the MoE layers under
    ``layers``."""
    g = gen.generator(device, seed, "lm/weights")
    dev = torch.device(device)
    d, h, v = cfg.d_model, cfg.n_heads, cfg.vocab
    kvr, rope, nope, vd = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    e, mff, shared = cfg.n_experts, cfg.moe_d_ff, cfg.n_shared_experts * cfg.moe_d_ff
    k = cfg.first_k_dense

    def dense(shape, fan_in):
        return torch.randn(shape, generator=g, device=dev).mul_(1.0 / math.sqrt(fan_in))

    def scale(shape):
        return torch.randn(shape, generator=g, device=dev).mul_(0.1).add_(1.0)

    def layers(n, ffn):
        return {
            "ln1": scale((n, d)),
            "ln2": scale((n, d)),
            "attn": {
                "wq": dense((n, d, h * (nope + rope)), d),
                "wdkv": dense((n, d, kvr), d),
                "kv_norm": scale((n, kvr)),
                "wkr": dense((n, d, rope), d),
                "wukv": dense((n, kvr, h * (nope + vd)), kvr),
                "wo": dense((n, h * vd, d), h * vd),
            },
            "ffn": ffn(n),
        }

    def swiglu(lead, ff):
        return {"w1": dense(lead + (d, ff), d), "w3": dense(lead + (d, ff), d),
                "w2": dense(lead + (ff, d), ff)}

    def moe(n):
        return {"router": dense((n, d, e), d), **swiglu((n, e), mff),
                "shared": swiglu((n,), shared)}

    return {
        "embed": dense((v, d), d),
        "final_norm": scale((d,)),
        "dense_layers": layers(k, lambda n: swiglu((n,), cfg.d_ff)),
        "layers": layers(cfg.n_layers - k, moe),
        "lm_head": dense((d, v), d),
    }


def checksum(weights) -> List[float]:
    """Each leaf's float64 sum, as ``lm_decode.checksum`` reads it, taken
    2**26 values at a time: a float64 copy of a whole expert leaf (19.2 GB
    in float32) would not fit beside the weights."""
    return [sum(float(part.sum(dtype=torch.float64)) for part in t.reshape(-1).split(1 << 26))
            for _, t in lm_decode._leaves(weights)]


def touched_experts(e: int, k: int, tokens: int) -> float:
    """Expected distinct experts that ``tokens`` tokens touch, each routed to
    ``k`` distinct experts of ``e`` at random."""
    return e * -math.expm1(tokens * math.log1p(-k / e))


def moe_work(m: Dict[str, float], batch: int, touched: Optional[float] = None) -> Work:
    """The MoE layers' work in one decode step of ``batch`` tokens: the
    router (read once, ``2 d E`` FLOPs a token), the ``touched`` routed
    experts a layer (each read once; :func:`touched_experts` where None) and
    the ``T * K`` pairs' FLOPs, the shared experts (read once, every
    token)."""
    n_moe = m["n_layers"] - m["first_k_dense"]
    d, e, k, mff = m["d_model"], m["n_experts"], m["experts_per_token"], m["moe_d_ff"]
    if touched is None:
        touched = touched_experts(e, k, batch)
    expert = 3 * d * mff
    shared = m["n_shared_experts"] * expert
    weights = d * e + touched * expert + shared
    flops = 2.0 * batch * (d * e + k * expert + shared)
    return Work(n_moe * flops, n_moe * 4.0 * weights, 0.0)


@dataclasses.dataclass(frozen=True)
class StepWork(Work):
    """A ``Work`` that carries its MoE part (:func:`moe_work`)."""

    moe: Work = Work()


def step_work(m: Dict[str, float], batch: int, attended: int,
              touched: Optional[float] = None) -> StepWork:
    """The work of one decode step of ``batch`` sequences attending
    ``attended`` cached positions, ``touched`` routed experts a layer (see
    the module's docstring and :func:`moe_work`)."""
    n, k_dense, d, h, v = (m["n_layers"], m["first_k_dense"], m["d_model"], m["n_heads"],
                           m["vocab"])
    kvr, rope, nope, vd = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    attn = (d * h * (nope + rope) + d * kvr + d * rope + kvr * h * (nope + vd) + h * vd * d)
    matrices = n * attn + k_dense * 3 * d * m["d_ff"] + d * v
    norms = n * (2 * d + kvr) + d
    latent = kvr + rope
    moe = moe_work(m, batch, touched)
    flops = 2.0 * batch * matrices + n * batch * 2.0 * h * attended * (2 * kvr + rope) + moe.flops
    nbytes = (4.0 * (matrices + norms) + 4.0 * batch * d + moe.nbytes
              + m["cache_bytes"] * n * batch * latent * (attended + 1) + 4.0 * batch * v)
    return StepWork(flops, nbytes, 0.0, moe=moe)


class Run(lm_decode.Run):
    """``lm_decode.Run`` over this kind's model: its weights, its work count
    and its check; a call is one step of the batch's decode session."""

    def __init__(self, config: dict, mix: dict, seed: int, seconds: float, traced: bool, *,
                 device, marks=None):
        from repro_torch.models import lm

        marks = [] if marks is None else marks
        # an earlier run of this process (calibrate.py's faults) may still hold
        # its 63 GB of weights in a reference cycle
        gc.collect()
        self.lm, self.config, self.seed, self.dev = lm, config, seed, torch.device(device)
        self.cfg = cfg = arch_config(config)
        self.model = _model(cfg)
        self.n_prompts, self.asks = int(mix["prompts"]), int(mix["asks"])
        self.prompt_len, self.answer_len = int(mix["prompt_len"]), int(mix["answer_len"])
        self.batch = self.per_call = self.n_prompts * self.asks
        self.max_len = self.prompt_len + self.answer_len
        self.judge_within = min(int(mix["judge_within"]), self.answer_len)
        self.warm_calls = int(mix["warm_calls"])
        self.trace_calls = int(mix["trace_calls"]) if traced else 0
        self.breakdown_calls = int(mix["breakdown_calls"]) if traced else 0

        torch.empty(0, device=self.dev)
        sync(self.dev)
        marks.append(("imports and context", time.perf_counter()))
        self.w = make_weights(cfg, seed, self.dev)
        sync(self.dev)
        marks.append(("weights", time.perf_counter()))
        shapes = {k: (tuple(t.shape), t.dtype) for k, t in lm_decode._leaves(lm.param_shapes(cfg))}
        drawn = {k: (tuple(t.shape), t.dtype) for k, t in lm_decode._leaves(self.w)}
        if shapes != drawn:
            raise ValueError(f"the program's parameter layout is not the drawn one: "
                             f"{sorted(set(shapes.items()) ^ set(drawn.items()))}")
        self.sums = checksum(self.w)
        g = gen.generator(self.dev, seed, "lm/tokens")
        self.prompts = torch.randint(0, cfg.vocab, (self.n_prompts, self.prompt_len),
                                     generator=g, device=self.dev)
        steps = (float(mix["step_rate"]) * seconds + self.warm_calls + self.trace_calls
                 + self.breakdown_calls)
        self.rounds = int(math.ceil(steps / self.answer_len)) + 1
        self.answers = torch.randint(0, cfg.vocab, (self.rounds, self.answer_len, self.batch),
                                     generator=g, device=self.dev)
        jg = torch.Generator().manual_seed(gen.sub_seed(seed, "lm/judge"))
        self.judge_steps = sorted(torch.randperm(self.judge_within, generator=jg)[
            :int(mix["judge_steps"])].tolist())
        half, k = self.batch // 2, int(mix["judge_sequences"]) // 2
        first = torch.randperm(half, generator=jg)[:k].tolist()
        others = [b for b in range(half, self.batch)
                  if b % self.n_prompts != first[0] % self.n_prompts]
        if len(others) < k:
            raise ValueError(f"{k} judged sequences a half need more prompts or asks")
        self.judge_seqs = sorted(first + [others[i] for i in torch.randperm(
            len(others), generator=jg)[:k].tolist()])
        sync(self.dev)
        marks.append(("ids and checksum", time.perf_counter()))
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        with torch.no_grad():
            self.cache = lm.init_cache(cfg, self.batch, self.max_len, device=self.dev)
            for p in range(self.n_prompts):
                _, one = lm.prefill(cfg, self.w, {"tokens": self.prompts[p:p + 1]}, self.max_len)
                for key, buf in self.cache.items():
                    buf[:, p::self.n_prompts] = one[key]
                del one
        sync(self.dev)
        marks.append(("prefill", time.perf_counter()))
        self.touched = self.routing(ROUTING_STEPS)
        log(f"touched experts a layer and step: {self.touched:.2f} by the program's routing "
            f"over {min(ROUTING_STEPS, self.answer_len)} steps; independent routing "
            f"{touched_experts(cfg.n_experts, cfg.experts_per_token, self.batch):.2f}")
        marks.append(("routing", time.perf_counter()))
        from repro_torch.serving.decode import DecodeSession

        self.session = DecodeSession(cfg, self.w, self.cache)
        self.offset = 0
        self.kept = {}
        self.substitute = None   # the control: a dtype the reference takes the program's place in

    def routing(self, steps: int) -> float:
        """The distinct routed experts a layer that the program's routing
        picks in the batch's first ``steps`` decode steps of round 0, over
        the steps and the MoE layers on average. The steps run eagerly, and
        the cache slots they write are put back after."""
        from repro_torch.models import moe

        steps = min(steps, self.answer_len)
        slots = slice(self.prompt_len, self.prompt_len + steps)
        kept = {key: t[:, :, slots].clone() for key, t in self.cache.items()}
        route, picked = moe._route, []

        def probe(p, x2d, cfg):
            out = route(p, x2d, cfg)
            picked.append(out[1].reshape(-1))
            return out
        moe._route = probe
        try:
            with torch.no_grad():
                for j in range(steps):
                    self.lm.decode_step(self.cfg, self.w, self.cache, self.answers[0, j],
                                        self.prompt_len + j)
        finally:
            moe._route = route
            for key, t in self.cache.items():
                t[:, :, slots] = kept[key]
        picked = torch.stack(picked)
        hit = torch.zeros(picked.shape[0], self.cfg.n_experts, device=picked.device)
        return float(hit.scatter_(1, picked, 1.0).sum(1).mean())

    def call(self, x):
        _, j, ids = x
        with torch.no_grad():
            logits = self.session.step(ids, self.prompt_len + j)
        sync(self.dev)
        return logits

    def release(self) -> None:
        self.session = None
        super().release()

    def work(self, i0: int, i1: int) -> StepWork:
        flops = nbytes = moe_flops = moe_bytes = 0.0
        for i in range(i0, i1):
            j = (i - self.offset) % self.answer_len
            w = step_work(self.model, self.batch, self.prompt_len + j + 1, self.touched)
            flops, nbytes = flops + w.flops, nbytes + w.nbytes
            moe_flops, moe_bytes = moe_flops + w.moe.flops, moe_bytes + w.moe.nbytes
        return StepWork(flops, nbytes, 0.0, moe=Work(moe_flops, moe_bytes, 0.0))

    def check(self):
        t0 = time.perf_counter()
        limit = float(self.config["check"]["logit_gap"])
        tie = float(self.config["check"]["tie_margin"])
        want = (self.batch, self.cfg.vocab)
        # tokens that a swapped routing may judge: a sixteenth of the judged
        most = max(1, len(self.judge_seqs) * len(self.judge_steps) // 16)
        malformed = sum(int(t.shape != want) or int((~torch.isfinite(t)).any(-1).sum())
                        for t in self.kept.values())
        rounds = sorted({r for r, _ in self.kept})
        full = [r for r in rounds if all((r, j) in self.kept for j in self.judge_steps)]
        cands = full or rounds
        gaps, swapped = [], 0
        if cands:
            g = torch.Generator().manual_seed(gen.sub_seed(self.seed, "lm/judge-round"))
            r = cands[int(torch.randint(0, len(cands), (1,), generator=g))]
            steps = [j for j in self.judge_steps if (r, j) in self.kept]
            rows = [self.prompt_len + j for j in steps]
            judged = []
            for b in self.judge_seqs:
                seq = self._sequence(b, r, steps[-1])
                ref, margin = lm_moe_reference.forward(self.w, self.model, seq, rows,
                                                       with_margins=True)
                if self.substitute is None:
                    held = [self.kept[(r, j)] for j in steps]
                    prog = (torch.stack([t[b] for t in held]).float()
                            if all(t.shape == want for t in held)
                            else torch.full_like(ref, math.nan))
                else:
                    prog = lm_moe_reference.forward(self.w, self.model, seq, rows,
                                                    dtype=self.substitute)
                gap = _gap(prog, ref)
                gap = torch.where(torch.isnan(gap), math.inf, gap)
                judged.append((seq, prog, gap.tolist(), margin))
            over = [(i, n) for i, (_, _, gap, margin) in enumerate(judged)
                    for n, x in enumerate(gap)
                    if x > limit * SWAP_SHARE and bool((margin[n] < tie).any())]
            if len(over) <= most:
                for i, n in over:
                    seq, prog, gap, margin = judged[i]
                    # the same sequence and rows as the first run, so that every
                    # other decision, near-ties included, is rounded as it was
                    for layer in (margin[n] < tie).nonzero()[:, 0].tolist():
                        alt = lm_moe_reference.forward(self.w, self.model, seq, rows,
                                                       swap=[(rows[n], layer)])
                        gap[n] = min(gap[n], float(_gap(prog[n:n + 1], alt[n:n + 1])[0]))
                    swapped += 1
            widest = [max(gap) for _, _, gap, _ in judged]
            gaps = [x for _, _, gap, _ in judged for x in gap]
            log(f"judged round {r}, {len(steps)} steps from {steps[0]} to {steps[-1]}, sequences "
                f"{self.judge_seqs}: widest logit gap a sequence "
                + ", ".join(f"{x:.3e}" for x in widest)
                + f"; {len(over)} tokens over {limit * SWAP_SHARE:g} within {tie:g} of a "
                f"routing tie, {swapped} judged against the swapped routing; "
                "least routing margin a sequence "
                + ", ".join(f"{float(m.min()):.3e}" for _, _, _, m in judged))
        else:
            log("no judged answer was held: the window made no call")
        logit_gap = max(gaps, default=math.inf)
        checks = {
            "logit_gap": (logit_gap, limit),
            "swapped": (swapped, most),
            "malformed": (malformed, 0),
            "weights_changed": (sum(a != b for a, b in zip(self.sums, checksum(self.w))), 0),
        }
        failed = malformed + sum(x > limit for x in gaps) + (0 if gaps else 1)
        log(f"check s: {time.perf_counter() - t0:.3f}")
        return checks, failed


def _gap(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's logit gap, max |program - reference| / (1 + max |reference|)."""
    return (prog - ref).abs().amax(-1) / (1.0 + ref.abs().amax(-1))


def setup(config: dict, mix: dict, seed: int, seconds: float, traced: bool, *, device,
          hook=None, marks=None):
    run = Run(config, mix, seed, seconds, traced, device=device, marks=marks)
    return run if hook is None else hook(run)
