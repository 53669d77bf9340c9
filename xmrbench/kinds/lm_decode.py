"""The LM decode kind: ``repro_torch``'s language model on one card, through
its normal path (``models.lm.prefill`` and ``models.lm.decode_step``),
decoding a batch of sequences against caches that set-up prefilled.

The configuration names the port's architecture (``arch``: the registered
``get_config``, with the sizes of ``model`` in its place, which state it
as run) and the check's limits. The mix (``traffic/<name>.json``, mode
``decode``) sets ``prompts`` distinct prompts of ``prompt_len`` ids, each
asked by ``asks`` sequences (sequence ``b`` asks prompt ``b % prompts``),
and answers of ``answer_len`` ids.

Set-up, from the seed: the weights, drawn on the device in the program's
layout (one draw a stacked leaf: matrices N(0, 1) / sqrt(fan-in) as the
port's initialisers draw them, norm scales 1 + N(0, 0.1)); the prompts and
the answers, seeded ids uniform over the vocabulary; the batch's cache
(``lm.init_cache``), filled by ``lm.prefill`` once a prompt, one prompt at
a time, each prompt's cache copied into the sequences that ask it. A call
is one ``lm.decode_step`` of the whole batch: every sequence's next answer
id, teacher-forced, at position ``prompt_len + j`` (``j`` the step of the
answer). After ``answer_len`` steps the batch rewinds to ``prompt_len``
and the next answers are new seeded ids, so every program decodes the same
tokens. The window starts at an answer's first step.

The check (:func:`Run.check`): ``judge_sequences`` sequences, half in each
half of the batch and not all of one prompt, at ``judge_steps`` steps among
the first ``judge_within`` of one answer (a round that the window
completed, where it completed one), all drawn from the seed; the program's logits are the tensors its window calls
returned (the window holds those of the drawn steps, nothing more). The
plain reference (:mod:`xmrbench.lm_reference`) runs each sequence's prompt
and answer up to its last judged step in full. ``logit_gap`` is max |program
- reference| / (1 + max |reference|) over a step's logits, the widest of the
judged; ``malformed`` counts held answers of the wrong shape or not finite;
``weights_changed`` the leaves whose checksum moved.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List

import torch

from xmrbench import gen, lm_reference
from xmrbench.kinds import log, sync
from xmrbench.work import Work

#: Keys of ``model`` that are not fields of the port's ``ArchConfig``: the
#: dtypes, compared with its ``param_dtype`` and ``activ_dtype`` (the cache's).
DTYPES = {"param_dtype": "param_dtype", "cache_dtype": "activ_dtype"}


def arch_config(config: dict):
    """The port's ``ArchConfig`` as the configuration runs it."""
    from repro_torch.configs.base import get_config

    base = get_config(config["arch"])
    model = dict(config["model"])
    for key, field in DTYPES.items():
        want = model.pop(key, None)
        have = str(getattr(base, field)).removeprefix("torch.")
        if want is not None and want != have:
            raise ValueError(f"{key} {want!r}: the port's {config['arch']} runs {have}")
    unknown = set(model) - {f.name for f in dataclasses.fields(base)}
    if unknown:
        raise ValueError(f"not fields of the port's ArchConfig: {sorted(unknown)}")
    return dataclasses.replace(base, **model)


def validate(config: dict, mix: dict) -> None:
    cfg = arch_config(config)
    if cfg.family != "dense" or cfg.attn_type != "mla" or cfg.activations_bf16:
        raise ValueError("the reference covers f32 dense decoders with MLA attention only")
    if mix["mode"] != "decode":
        raise ValueError(f"unknown mix mode {mix['mode']!r}")
    if int(mix["prompts"]) < 2 or int(mix["asks"]) < 1:
        raise ValueError("the check draws sequences of different prompts")
    if int(mix["prompts"]) * int(mix["asks"]) % 2 or int(mix["judge_sequences"]) % 2:
        raise ValueError("the check draws as many sequences in each half of the batch")
    if not 1 <= int(mix["judge_steps"]) <= min(int(mix["judge_within"]), int(mix["answer_len"])):
        raise ValueError("judge_steps outside [1, min(judge_within, answer_len)]")


def _model(cfg) -> Dict[str, float]:
    keys = ("n_layers", "d_model", "n_heads", "q_lora_rank", "kv_lora_rank", "qk_rope_dim",
            "qk_nope_dim", "v_head_dim", "d_ff", "vocab", "rope_theta")
    return {k: getattr(cfg, k) for k in keys}


def make_weights(cfg, seed: int, device) -> dict:
    """The weights in the program's layout, one draw a stacked leaf."""
    g = gen.generator(device, seed, "lm/weights")
    dev = torch.device(device)
    n, d, h, v = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab
    qr, kvr, rope = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_dim
    nope, vd, ff = cfg.qk_nope_dim, cfg.v_head_dim, cfg.d_ff

    def dense(shape, fan_in):
        return torch.randn(shape, generator=g, device=dev).mul_(1.0 / math.sqrt(fan_in))

    def scale(shape):
        return torch.randn(shape, generator=g, device=dev).mul_(0.1).add_(1.0)

    return {
        "embed": dense((v, d), d),
        "final_norm": scale((d,)),
        "layers": {
            "ln1": scale((n, d)),
            "ln2": scale((n, d)),
            "attn": {
                "wdq": dense((n, d, qr), d),
                "q_norm": scale((n, qr)),
                "wuq": dense((n, qr, h * (nope + rope)), qr),
                "wdkv": dense((n, d, kvr), d),
                "kv_norm": scale((n, kvr)),
                "wkr": dense((n, d, rope), d),
                "wukv": dense((n, kvr, h * (nope + vd)), kvr),
                "wo": dense((n, h * vd, d), h * vd),
            },
            "ffn": {"w1": dense((n, d, ff), d), "w3": dense((n, d, ff), d),
                    "w2": dense((n, ff, d), ff)},
        },
        "lm_head": dense((d, v), d),
    }


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def checksum(weights) -> List[float]:
    """Each leaf's float64 sum: read again after the window, it shows
    whether anything wrote into the weights."""
    return [float(t.sum(dtype=torch.float64)) for _, t in _leaves(weights)]


def decode_work(m: Dict[str, float], batch: int, attended: int) -> Work:
    """The work of one decode step of ``batch`` sequences attending
    ``attended`` cached positions, counted from shapes, whatever form
    computes it: every weight read once (of the embedding, the batch's
    rows), the latent cache (``kv_lora_rank + qk_rope_dim`` bf16 values a
    position and layer) read once and its new slot written, the logits
    written in f32; the FLOPs of the absorbed form (the up-projections
    folded into the query and the output, attention over the latents)."""
    n, d, h, v = m["n_layers"], m["d_model"], m["n_heads"], m["vocab"]
    qr, kvr, rope = m["q_lora_rank"], m["kv_lora_rank"], m["qk_rope_dim"]
    nope, vd, ff = m["qk_nope_dim"], m["v_head_dim"], m["d_ff"]
    per_layer = (d * qr + qr * h * (nope + rope) + d * kvr + d * rope
                 + kvr * h * (nope + vd) + h * vd * d + 3 * d * ff)
    matrices = n * per_layer + d * v
    norms = n * (2 * d + qr + kvr) + d
    attn = 2.0 * h * attended * ((kvr + rope) + kvr)
    flops = 2.0 * batch * matrices + n * batch * attn
    latent = kvr + rope
    nbytes = (4.0 * (matrices + norms) + 4.0 * batch * d
              + 2.0 * n * batch * latent * (attended + 1) + 4.0 * batch * v)
    return Work(flops, nbytes, 0.0)


class Run:
    """One cell's weights, inputs and batch cache. A call is one decode step
    of the batch; its input ``(round, step, ids)``."""

    mode = "decode"

    def __init__(self, config: dict, mix: dict, seed: int, seconds: float, traced: bool, *,
                 device, marks=None):
        from repro_torch.models import lm

        marks = [] if marks is None else marks
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
        shapes = {k: (tuple(t.shape), t.dtype) for k, t in _leaves(lm.param_shapes(cfg))}
        drawn = {k: (tuple(t.shape), t.dtype) for k, t in _leaves(self.w)}
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
        self.offset = 0
        self.kept: Dict[tuple, torch.Tensor] = {}
        self.substitute = None   # the control: a dtype the reference takes the program's place in

    def next_input(self, i: int):
        r, j = divmod(i - self.offset, self.answer_len)
        return r, j, self.answers[r % self.rounds, j]

    def call(self, x):
        _, j, ids = x
        with torch.no_grad():
            logits, _ = self.lm.decode_step(self.cfg, self.w, self.cache, ids, self.prompt_len + j)
        sync(self.dev)
        return logits

    def begin_window(self, i: int) -> None:
        self.offset = i

    def keep(self, i: int, x, out) -> None:
        r, j, _ = x
        if j in self.judge_steps:
            self.kept[(r, j)] = out

    def work(self, i0: int, i1: int) -> Work:
        total = Work()
        for i in range(i0, i1):
            j = (i - self.offset) % self.answer_len
            total = total + decode_work(self.model, self.batch, self.prompt_len + j + 1)
        return total

    def release(self) -> None:
        rounds = max((r for r, _ in self.kept), default=-1) + 1
        if rounds > self.rounds:
            log(f"the answers wrapped: {rounds} rounds sent, {self.rounds} drawn")
        self.cache = None

    def _sequence(self, b: int, r: int, last: int) -> torch.Tensor:
        return torch.cat([self.prompts[b % self.n_prompts],
                          self.answers[r % self.rounds, :last + 1, b]])

    def check(self):
        t0 = time.perf_counter()
        limit = float(self.config["check"]["logit_gap"])
        want = (self.batch, self.cfg.vocab)
        malformed = sum(int(t.shape != want) or int((~torch.isfinite(t)).any(-1).sum())
                        for t in self.kept.values())
        rounds = sorted({r for r, _ in self.kept})
        full = [r for r in rounds if all((r, j) in self.kept for j in self.judge_steps)]
        cands = full or rounds
        gaps = []
        if cands:
            g = torch.Generator().manual_seed(gen.sub_seed(self.seed, "lm/judge-round"))
            r = cands[int(torch.randint(0, len(cands), (1,), generator=g))]
            steps = [j for j in self.judge_steps if (r, j) in self.kept]
            rows = [self.prompt_len + j for j in steps]
            widest = []
            for b in self.judge_seqs:
                seq = self._sequence(b, r, steps[-1])
                ref = lm_reference.forward(self.w, self.model, seq, rows)
                if self.substitute is None:
                    held = [self.kept[(r, j)] for j in steps]
                    prog = (torch.stack([t[b] for t in held]).float()
                            if all(t.shape == want for t in held)
                            else torch.full_like(ref, math.nan))
                else:
                    prog = lm_reference.forward(self.w, self.model, seq, rows,
                                                dtype=self.substitute)
                gap = (prog - ref).abs().amax(-1) / (1.0 + ref.abs().amax(-1))
                gap = torch.where(torch.isnan(gap), math.inf, gap).tolist()
                widest.append(max(gap))
                gaps += gap
            log(f"judged round {r}, {len(steps)} steps from {steps[0]} to {steps[-1]}, sequences "
                f"{self.judge_seqs}: widest logit gap a sequence "
                + ", ".join(f"{x:.3e}" for x in widest))
        else:
            log("no judged answer was held: the window made no call")
        logit_gap = max(gaps, default=math.inf)
        checks = {
            "logit_gap": (logit_gap, limit),
            "malformed": (malformed, 0),
            "weights_changed": (sum(a != b for a, b in zip(self.sums, checksum(self.w))), 0),
        }
        failed = malformed + sum(x > limit for x in gaps) + (0 if gaps else 1)
        log(f"check s: {time.perf_counter() - t0:.3f}")
        return checks, failed


def setup(config: dict, mix: dict, seed: int, seconds: float, traced: bool, *, device,
          hook=None, marks=None):
    run = Run(config, mix, seed, seconds, traced, device=device, marks=marks)
    return run if hook is None else hook(run)


# ---------------------------------------------------------------------------
# what the check has to catch: the control and the faults
# ---------------------------------------------------------------------------

def control_hook(dtype=torch.bfloat16):
    """The reference in ``dtype`` (weights and activations) in the program's
    place at the judged steps."""
    def hook(run):
        run.substitute = dtype
        return run
    return hook


def _alter_logit(run):
    """An answer altered where it is produced: one logit of every sequence
    moved by 1."""
    call = run.call

    def altered(x):
        out = call(x)
        out[:, 0] += 1.0
        return out
    run.call = altered
    return run


def _stale_cache(run):
    """A step that leaves its state as it was: each step's new cache slot
    is put back after the step."""
    call = run.call

    def stale(x):
        slot = min(run.prompt_len + x[1], run.max_len - 1)
        old = {k: t[:, :, slot].clone() for k, t in run.cache.items()}
        out = call(x)
        for k, t in run.cache.items():
            t[:, :, slot] = old[k]
        return out
    run.call = stale
    return run


def _drop_half(run):
    """Half of the batch left out: the first half decoded, its logits
    handed back for the second half too."""
    def half(x):
        h = run.batch // 2
        cache = {k: t[:, :h] for k, t in run.cache.items()}
        with torch.no_grad():
            logits, _ = run.lm.decode_step(run.cfg, run.w, cache, x[2][:h],
                                           run.prompt_len + x[1])
        sync(run.dev)
        return torch.cat([logits, logits])
    run.call = half
    return run


def _changed_weight(run):
    """A weight written after set-up's checksum."""
    run.w["layers"]["attn"]["wo"][0].view(-1)[0] += 1.0
    return run


FAULTS = {"alter_logit": _alter_logit, "stale_cache": _stale_cache,
          "drop_half": _drop_half, "changed_weight": _changed_weight}


def fault_hooks(mix: dict):
    return dict(FAULTS)
