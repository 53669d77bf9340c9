"""PyTorch port, DeepSeek-V2-Lite's decode step in a decode session
(``serving.decode.DecodeSession``), replayed from CUDA graphs on a card.

On the CPU: the step on a device position (a tensor ``[1]``, which a
graph's replays read) is bitwise the step on an int position, logits and
cache; off a card a session's steps are eager and are ``lm.decode_step``'s;
a graph's span template (``obs.template``) comes back, for each replay,
as copies inside the replay's root span. On the card (skipped without one,
from the fixture): a session's first step eager, its second recorded and
replayed, every replay bitwise the eager step on a copy of the cache, over
positions back to back, each answer read again after the later steps; a
step while spans are recorded is a replay too, and each of its stages has
a device interval. The file imports nothing of JAX.
"""

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import lm
from repro_torch.serving.decode import DecodeSession

PROMPT, STEPS = 12, 5
STAGES = ("mla.decode", "ffn.dense", "moe.route", "moe.routed", "moe.shared")


def _setup(device):
    cfg = reduced_config(get_config("deepseek-v2-lite"))
    g = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, g, device=device)
    tokens = torch.randint(0, cfg.vocab, (4, PROMPT + STEPS), generator=g).to(device)
    with torch.no_grad():
        _, cache = lm.prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, PROMPT + STEPS)
    return cfg, params, tokens, cache


def test_device_position_is_the_int_position():
    cfg, params, tokens, cache = _setup("cpu")
    other = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad():
        for j in range(PROMPT, PROMPT + STEPS):
            want, _ = lm._decode_step(cfg, params, cache, tokens[:, j], j)
            got, _ = lm._decode_step(cfg, params, other, tokens[:, j], torch.tensor([j]))
            assert torch.equal(got, want)
    for key in cache:
        assert torch.equal(other[key], cache[key])


def test_steps_off_a_card_are_eager():
    cfg, params, tokens, cache = _setup("cpu")
    eager = {k: v.clone() for k, v in cache.items()}
    session = DecodeSession(cfg, params, cache)
    assert not session.graphs
    with torch.no_grad():
        for j in range(PROMPT, PROMPT + 3):
            want, _ = lm.decode_step(cfg, params, eager, tokens[:, j], j)
            assert torch.equal(session.step(tokens[:, j], j), want)
    assert not session._graphs
    for key in cache:
        assert torch.equal(session.cache[key], eager[key])


def test_a_template_comes_back_inside_each_replay():
    """Spans entered under ``obs.template`` go to the template, not the
    buffer; ``obs.replayed`` puts a copy of them in the buffer, nested as
    they were, inside the open root span, with the capture's counts, once a
    replay and only while spans are recorded."""
    obs.clear()
    with obs.template() as template:
        with obs.span("outer", kind=1):
            with obs.span("inner"):
                obs.count("rows", 3)
    assert [s.name for s in template] == ["inner", "outer"] and not obs.spans()
    obs.replayed(template, obs.clock_ns())
    assert not obs.spans()
    with obs.recording():
        for _ in range(2):
            with obs.span("serve.decode", engine=1, queries=2):
                obs.replayed(template, obs.clock_ns())
    got = obs.spans()
    obs.clear()
    roots = [s for s in got if s.parent is None]
    assert [s.name for s in roots] == ["serve.decode"] * 2
    for root in roots:
        one = {s.name: s for s in got if s.call == root.sid and s is not root}
        assert set(one) == {"outer", "inner"}
        assert one["outer"].parent == root.sid and one["inner"].parent == one["outer"].sid
        assert one["inner"].counts == {"rows": 3} and one["outer"].attrs == {"kind": 1}
        assert one["outer"].device_ms is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_replays_are_bitwise_the_eager_step(cuda_device):
    cfg, params, tokens, cache = _setup(cuda_device)
    eager = {k: v.clone() for k, v in cache.items()}
    session = DecodeSession(cfg, params, cache)
    served = []
    with torch.no_grad():
        for j in range(PROMPT, PROMPT + STEPS):
            logits = session.step(tokens[:, j], j)
            want, _ = lm._decode_step(cfg, params, eager, tokens[:, j], j)
            served.append((logits, want))
        assert list(session._graphs.values())[0] is not None
        for logits, want in served:
            assert torch.equal(logits, want)
        for key in cache:
            assert torch.equal(cache[key], eager[key])
        # while spans are recorded the step is a replay whose stages have
        # device intervals
        obs.clear()
        j = PROMPT + STEPS - 1
        with obs.recording():
            logits = session.step(tokens[:, j], j)
            spans = obs.spans()
        obs.clear()
        want, _ = lm._decode_step(cfg, params, eager, tokens[:, j], j)
        assert torch.equal(logits, want)
    root = [s for s in spans if s.name == "serve.decode"]
    assert len(root) == 1 and root[0].parent is None
    stages = [s for s in spans if s.call == root[0].sid and s is not root[0]]
    names = [s.name for s in stages]
    assert names.count("mla.decode") == cfg.n_layers and names.count("ffn.dense") == 1
    for name in STAGES[2:]:
        assert names.count(name) == cfg.n_layers - 1
    assert all(s.parent == root[0].sid for s in stages if s.name in STAGES)
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in stages)
    assert sum(s.device_ms for s in stages) <= root[0].device_ms * 1.01 + 0.05
